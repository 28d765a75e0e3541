"""Drive the PyTorch / CUDA port on one GPU and hold it to its plain version.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device: a CUDA device must be present; print its name and power limit;
2. build: compile every CUDA source of the port (nine) with nvcc
   (sm_90a), one nvcc per source, all started together; report each
   flash-kernel width's registers and spills (``-Xptxas -v``) and count
   the tensor-core instructions (HGMMA, HMMA) in the flash library's SASS
   (``cuobjdump -sass``): the bf16 kernels must have them; report the
   registers, static shared memory, stack frame and spills of the
   kernels of #1 and #4 (the KWN layer's ``kwn_head<CPL>``, ``kwn_lif``,
   in each library), #3 (``fmskb_mac``, ``fmskb_chain``,
   ``fmskb_dw_part``, ``fmskb_dw_sum``) and #2 (``fmsn_head<CPT>``,
   ``fmsn_lif``), failing if one is missing; and the registers, stack
   frame and spills of #5's ``tmac_kernel<KT>``, #6's ``nlq_kernel<VEC,
   REG>``, #7's ``kwn_kernel<CPL, VEC>`` and #8's ``lif_kernel*`` with the
   int8 tensor-core instructions (IMMA, IGMMA) in #5's SASS: #5 must have
   them, none may spill, and #6 and #8 may have no stack frame;
3. kernels vs plain versions, on the same inputs on the card:
   - KWN: the public wrapper ``ops.fused_macro_seq`` (padding,
     ``n_valid``, activity gating, ``row_ctl`` or a scalar seed) against
     ``kernels/ref.py`` on the same unpadded inputs, at the engine's round
     shape, at T=32, at a ragged shape, at N=200 (padded to 256) and at
     N=1024 (MAX_COLS), clean and with counter noise, and at the training
     shape (T=30, M=64) with the Fig. 7 noise and the training trace;
   - NLD: ``ops.fused_macro_seq(mode="nld")`` the same way, at the
     DVS-Gesture round shape and sequence (J=2 branches of 128 neurons),
     at a ragged shape with per-branch column padding (J=3), at J=2 x
     N=50 (unpadded, so a neuron's branches sit on other lanes), at J=2 x
     N=512 (1024 columns) over T=30 and at J=6;
   - the KWN stack: the stacked kernel's wrapper against its plain
     version on the same padded operands, at the DVS-Gesture stack
     (two 128-column layers, T=30), at a ragged three-layer shape, one
     layer of 256, four layers (128, 200, 64, 20), three layers of 512
     (which the one-warp-a-row kernel refused) and (1024, 200) at T=30;
   all exact: 0 mismatches, MAC and ADC steps equal, membranes 0 ULP;
   - training: the KWN forward with its training trace through
     ``ops.fused_macro_seq(train_trace=True)`` (trace 0 ULP), and the
     surrogate backward kernel on its residuals (``ops.seq_grad_operands``)
     against ``ref.fused_macro_seq_grad_ref``, at the training shape
     (T=30, M=64, K=512, N=128) and a padded one, clean and noisy,
     residual and remat, gated and dense: dv0 0 ULP, dW within rtol 1e-5 /
     atol 1e-6, and the same dW bits for every launch;
   - the composed chain's kernels (``ternary_mac``, ``nlq_convert``,
     ``kwn_topk``, ``lif_step`` through their ``ops`` wrappers) at the
     chain's step shape (M=64, K=512, N=128), the bench's macro shape
     (128, 256, 128) and a ragged one (37, 300, 100): the MAC at ratios 2,
     3 and 2.05, the ramp at nlq / linear / activation codebooks of 5 and
     6 bits, KWN at k = 0, 1, 12, N, N + 5, the LIF with SNL on and off;
     and the edges of #5's split-K tensor-core design (M = 1 and 17; K =
     0, 32, 48 and 1000; N = 8, 100 and 1024; the stack chain's layer 2,
     64 x 128 x 128) at 5 % and 67 % events, #7 with a 6-bit codebook
     (n_codes 64) and at N = 1024, #6 at codebooks of 1, 2 and 8 bits,
     unsorted and NaN-holding ones, NaN / +-inf / +-0 and every
     boundary's f32 neighbours among the inputs, N = 100 and 101 and
     operands offset by one element, #8 on offset views, and both once at
     8192 x 1024; every output exact, membranes 0 ULP;
   - the flash-attention kernel (#9) through its wrapper against
     ``ref.flash_attention_ref``: f32 and bf16, causal and full, D in 16,
     32, 64, 128 at S in 128, 192, 1000 (ragged) and 2048, BH 72 at
     D = 64; D in 21, 80, 112, 192, 256 (padded inside the kernel's
     tiles) at S in 192 and 1000, and 2048 at D = 256; f32 within rtol =
     atol = 2e-5, bf16 within one bf16 ULP of the plain version's f32
     result rounded; the large-logit case (inputs x30, integer-valued so
     that the scores are exact in any sum order) at D = 16, 21, 64, 256;
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
   - training: ``snn.train`` on the DVS-Gesture dataset at full width,
     batch 64: 4 software steps (no kernel), then 8 silicon steps with
     the Fig. 7 noise, warm started (seq-KWN launches == backward
     launches == steps, no other kernel, finite losses); the first
     silicon step again on the CPU (spikes bit for bit, loss and grads
     within rtol 1e-5 / atol 1e-6); ``forward_silicon(fused="step")``
     against ``"seq"`` bit for bit with T launches, clean and noisy;
   - the composed path: ``forward_silicon(fused=False)`` on the
     DVS-Gesture KWN configuration (64 streams of 30 steps, 5 % events,
     clean with SNL) launches no kernel and equals the same call on the
     CPU and ``fused="seq"`` on the card (spike counts and telemetry bit
     for bit); the four-kernel chain (``ops.ternary_mac ->
     ops.nlq_convert -> ops.kwn_topk -> ops.lif_step`` with the model's
     planes and PRBS noise, the bench's ``_composed_step`` iterated)
     equals ``ops.fused_macro_seq`` and the composed forward bit for bit
     with 30 launches of each kernel; the same on the DVS-Gesture stack
     (the chain 8 launches a step, against the stacked kernel); the NLD
     composed forward against the CPU (telemetry equal, logits within
     rtol 1e-5 / atol 1e-6); the noisy composed forward, and the Fig. 7
     statistics of its conversion on the card;
   - the LM: smollm-135m at full width (30 layers, d_model 576, 9 heads
     over 3 kv heads, d_ff 1536, vocab 49152, bf16, random weights from
     the seed): ``lm.forward(prefill=True)`` on 8 prompts of 2048 tokens
     (30 flash launches, finite logits (8, padded_vocab)), ``pad_cache``
     to 2080 and 32 greedy ``decode_step``s (no launch); prefill against
     teacher-forced decode over 64 tokens in f32 (2e-3) and bf16
     (``BF16_TOL``); ``launch.serve.main`` with its defaults (8 requests,
     4 slots, 12 new tokens, no flash launch), its tokens equal to a
     prefill-plus-decode run of each prompt wherever the top-2 gap
     exceeds the tolerance; the same engine in CIM mode, finite logits;
   - the repaired faults: ``BatchedEngine`` (reduced smollm-135m, 1 slot,
     s_max 8) on prompts of 7, 8 and 9 tokens, so that positions reach
     and pass s_max, without a device assert and with the tokens of the
     same engine on the CPU; a prefill of nemotron-4-340b reduced to
     d_model 768 (its head_dim 192) through the flash kernel, one launch
     a layer, logits equal to the CPU's in f32;
5. timings: each kernel against its plain version on the card at its
   main path's shape (ms per round for KWN and NLD, ms per launch for the
   stack) beside its roofline bound, and #1 and #3 also by their device
   time under ``torch.profiler``; the KWN engine's requests/s and round
   ms p50/p95 over an 8192-request clean burst, and a breakdown of a
   1024-request burst under the engine tracer and ``torch.profiler``; the
   NLD engine's requests/s and whole-tick time over a 2048-request clean
   burst; at the training shape, the backward kernel per launch (residual
   and remat) against its plain version, its bound and one
   ``torch.matmul`` of the contraction alone, the forward with and
   without its trace, and the whole silicon step (ms, steps/s, device
   idle share under ``torch.profiler``, and the share of it in kernels
   #1 and #3); kernel #1 with its trace at the training shape against
   its plain version and bound; #2 and #4 also by their device time
   under the profiler, and #4's inter-layer spike scratch with rows
   padded to 16 bytes against unpadded rows at widths (200, 128);
   kernels #5-#8 per launch at the
   chain's step shape (CUDA events, and device time under the profiler)
   against their plain versions, bounds and, where one PyTorch call
   computes the same function, ``torch.matmul`` / ``torch.bucketize``
   (both clocks); #5 also at 67 % events and at the stack chain's layer 2
   (K = 128), beside ``torch._int_mm`` on the int8 operands (the integer
   sums only); #6 also with its 5-bit codebook permuted (the linear
   count); #6 and #8 also at M = 8192, N = 1024 (#6 at 5 and 6 bits,
   sorted and permuted) with the share of the bound they reach, beside
   the card's per-launch floor (``zero_()`` of one element);
   one chain step against one fused step launch (both clocks), and the
   composed forward against ``"seq"``; kernel #9 at BH=72, D=64, bf16, causal,
   S=2048 and 512, and at BH=16, S=2048, D=256 (gemma2's head_dim),
   against its plain version, its bound and
   ``scaled_dot_product_attention`` (timed only), the smollm prefill of
   8 x 2048 (with the kernel's share of device time), a decode step at
   batch 8 against 2080 slots, and ``BatchedEngine`` tokens/s with its
   device idle share.

The second-to-last line of standard output is the ``kernels`` JSON record;
the last line is ``{"ok": true, "device": {...}}``.  A longer record goes
to ``chiprun_out/chip_smoke.json``, the profiler's op tables to
``chiprun_out/chip_smoke_profile.txt`` (serving) and
``chiprun_out/chip_smoke_train_profile.txt`` (training).
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base as config_base  # noqa: E402
from repro_torch.core import dendrite as dendrite_lib  # noqa: E402
from repro_torch.core import f32math  # noqa: E402
from repro_torch.core import ima as ima_lib  # noqa: E402
from repro_torch.core import macro as macro_lib  # noqa: E402
from repro_torch.core import prbs as prbs_lib  # noqa: E402
from repro_torch.data import events as events_lib  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_lib  # noqa: E402
from repro_torch.kernels import fused_macro, fused_macro_grad  # noqa: E402
from repro_torch.kernels import kwn_topk as kwn_lib  # noqa: E402
from repro_torch.kernels import lif_step as lif_lib  # noqa: E402
from repro_torch.kernels import nlq_lut as nlq_lib  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ternary_mac as tmac_lib  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import lm, snn  # noqa: E402
from repro_torch.nn import module as nn_module  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402
from repro_torch.serve import lifecycle  # noqa: E402
from repro_torch.train import silicon as silicon_lib  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core ops
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core FLOP/s
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
SW_STEPS, SI_STEPS, TRAIN_BATCH = 4, 8, 64   # the training path
TRAIN_LR = 0.02                 # examples/train_snn_events.py fine-tune
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_KW = dict(drive_gain=CFG.drive_gain, beta=CFG.beta, v_th1=CFG.v_th1,
               v_lim=8.0, kwn_relax=silicon_lib.DEFAULT_KWN_RELAX,
               surrogate_beta=4.0, ste_lo=-CFG.mac_range - 0.5,
               ste_hi=CFG.mac_range + 0.5)
KERNELS = {"fused_macro_seq_kwn": fused_macro.fused_macro_seq,
           "fused_macro_seq_nld": fused_macro.fused_macro_seq_nld,
           "fused_macro_multi_seq_kwn": fused_macro.fused_macro_multi_seq,
           "fused_macro_seq_kwn_bwd": fused_macro_grad.fused_macro_seq_grad,
           "ternary_mac": tmac_lib.ternary_mac,
           "nlq_lut": nlq_lib.nlq_convert,
           "kwn_topk": kwn_lib.kwn_topk,
           "lif_step": lif_lib.lif_step_fused,
           "flash_attention": flash_lib.flash_attention_fwd}
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


def build_phase() -> tuple[float, dict, dict, dict]:
    secs = build.build_all()
    for name, text in build.BUILD_LOG.items():
        log(f"[nvcc {name}]\n{text.strip()}")
    log(f"build: {secs:.1f} s for {build.sources()}")
    return (secs, flash_build_report(), split_build_report(),
            stage_build_report())


SPLIT_KERNELS = {   # source -> its kernels: a parallel head, a serial LIF
    "fused_macro_seq_kwn": ("kwn_head", "kwn_lif"),
    "fused_macro_seq_kwn_bwd": ("fmskb_mac", "fmskb_chain", "fmskb_dw_part",
                                "fmskb_dw_sum"),
    "fused_macro_seq_nld": ("fmsn_head", "fmsn_lif"),
    "fused_macro_multi_seq_kwn": ("kwn_head", "kwn_lif")}


def split_build_report() -> dict:
    """Registers, static shared memory, stack frame and spill bytes
    (``-Xptxas -v``) of each kernel of #1 and #4 (``kwn_head<CPL>``,
    ``kwn_lif``), #3 (``fmskb_*``) and #2 (``fmsn_head<CPT>``,
    ``fmsn_lif``), keyed ``source/kernel``.  The staged-MAC kernels take
    their plane ring as dynamic shared memory (64 KB at 128 columns a
    tile), which ptxas does not report."""
    rep: dict = {}
    for src, names in SPLIT_KERNELS.items():
        # a length-prefixed name in the mangled one, with its template
        # argument
        pat = re.compile(r"\d(" + "|".join(names) + r")(?:ILi(\d+)E)?")
        cur = None
        for ln in build.BUILD_LOG.get(src, "").splitlines():
            m = re.search(r"Function properties for (_Z\S+)", ln)
            if m:
                k = pat.search(m.group(1))
                cur = None if k is None else rep.setdefault(
                    f"{src}/{k.group(1)}"
                    + (f"<{k.group(2)}>" if k.group(2) else ""), {})
            elif cur is not None and "spill stores" in ln:
                cur["stack_bytes"] = int(re.search(
                    r"(\d+) bytes stack frame", ln).group(1))
                cur["spill_bytes"] = sum(int(x) for x in re.findall(
                    r"(\d+) bytes spill", ln))
            elif cur is not None and "Used" in ln:
                cur["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
                cur = None
    missing = [f"{src}/{name}" for src, names in SPLIT_KERNELS.items()
               for name in names
               if not any(key.split("<")[0] == f"{src}/{name}"
                          for key in rep)]
    if missing:
        raise AssertionError(f"ptxas report lacks {missing}: {rep}")
    log("split kernels (registers / static smem / stack / spill bytes): "
        + ", ".join(f"{k} {v.get('registers')}/{v.get('static_smem_bytes')}"
                    f"/{v.get('stack_bytes')}/{v.get('spill_bytes')}"
                    for k, v in rep.items()))
    return rep


STAGE_BUILD = {"ternary_mac": "tmac_kernel", "kwn_topk": "kwn_kernel",
               "nlq_lut": "nlq_kernel", "lif_step": "lif_kernel"}


def _sass(source: str) -> str:
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass",
                           str(build._target(source))], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def stage_build_report() -> dict:
    """Registers, stack frame and spill bytes (``-Xptxas -v``) of each
    kernel of #5-#8 (``tmac_kernel<KT>``, ``nlq_kernel<VEC>``,
    ``kwn_kernel<CPL, VEC>``, ``lif_kernel``; a name's suffix and template
    arguments are kept in its key), and the int8 tensor-core instructions
    (IMMA, IGMMA) in #5's SASS.  Fails if any of them spills, if #6 or #8
    has a stack frame, if one lacks a report, or if #5 has no int8
    tensor-core instruction: its product would not be on the tensor
    cores."""
    rep: dict = {}
    for src, name in STAGE_BUILD.items():
        cur = None
        for ln in build.BUILD_LOG.get(src, "").splitlines():
            m = re.search(r"Function properties for (_Z\S+)", ln)
            if m:
                # a length-prefixed name, a suffix, template arguments
                k = re.search(r"\d(" + name + r"\w*?)(?:I((?:L[a-z]+\d+E)+)E)?"
                              r"(?=E)", m.group(1))
                args = [] if k is None or not k.group(2) else re.findall(
                    r"L[a-z]+(\d+)E", k.group(2))
                cur = None if k is None else rep.setdefault(
                    f"{src}/{k.group(1)}"
                    + (f"<{','.join(args)}>" if args else ""), {})
            elif cur is not None and "spill stores" in ln:
                cur["stack_bytes"] = int(re.search(
                    r"(\d+) bytes stack frame", ln).group(1))
                cur["spill_bytes"] = sum(int(x) for x in re.findall(
                    r"(\d+) bytes spill", ln))
            elif cur is not None and "Used" in ln:
                cur["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
                cur = None
    sass = _sass("ternary_mac")
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        m = re.search(r"tmac_kernelILi(\d+)E", fn.split("\n")[0])
        if m:
            entry = rep.setdefault(f"ternary_mac/tmac_kernel<{m.group(1)}>",
                                   {})
            entry["IMMA"] = len(re.findall(r"\bIMMA\.", fn))
            entry["IGMMA"] = len(re.findall(r"\bIGMMA\.", fn))
    tmac = {k: v for k, v in rep.items() if k.startswith("ternary_mac/")}
    if len(tmac) != 3 or not all(v.get("IMMA", 0) + v.get("IGMMA", 0) > 0
                                 for v in tmac.values()):
        raise AssertionError(f"#5 without int8 tensor-core SASS: {tmac}")
    if not all(any(k.startswith(f"{src}/") for k in rep)
               for src in STAGE_BUILD) \
            or any(v.get("spill_bytes", 1) for v in rep.values()):
        raise AssertionError(f"#5-#8 spill or lack a report: {rep}")
    framed = {k: v for k, v in rep.items()
              if k.split("/")[0] in ("nlq_lut", "lif_step")
              and v.get("stack_bytes", 1)}
    if framed:
        raise AssertionError(f"#6 or #8 with a stack frame: {framed}")
    log("stage kernels #5-#8 (registers / stack / spill bytes / IMMA): "
        + ", ".join(f"{k} {v.get('registers')}/{v.get('stack_bytes')}/"
                    f"{v.get('spill_bytes')}/{v.get('IMMA', '-')}"
                    for k, v in rep.items()))
    return rep


def flash_build_report() -> dict:
    """Registers and spill bytes of each flash-kernel instantiation (from
    ``-Xptxas -v``), ptxas's notes that it serialized wgmma, and the
    tensor-core instructions of each in the built library's SASS
    (``cuobjdump -sass``).  Fails if a bf16 kernel has no HGMMA: its
    products would not be on the tensor cores."""
    text = build.BUILD_LOG.get("flash_attention", "")
    rep: dict = {"kernels": {}, "serialized": sum(
        "Potential Performance Loss" in ln for ln in text.splitlines())}
    cur = None
    for ln in text.splitlines():
        m = re.search(r"Function properties for \S*flash_(bf16|f32)_kernel"
                      r"ILi(\d+)E", ln)
        if m:
            cur = rep["kernels"].setdefault(f"{m.group(1)}_{m.group(2)}", {})
        elif cur is not None and "spill stores" in ln:
            cur["spill_bytes"] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", ln))
        elif cur is not None and "Used" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            cur = None
    sass = _sass("flash_attention")
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        m = re.search(r"flash_(bf16|f32)_kernelILi(\d+)E", fn.split("\n")[0])
        if m:
            entry = rep["kernels"].setdefault(f"{m.group(1)}_{m.group(2)}",
                                              {})
            entry["HGMMA"] = len(re.findall(r"\bHGMMA\.", fn))
            entry["HMMA"] = len(re.findall(r"\bHMMA\.", fn))
    bf16 = {k: v for k, v in rep["kernels"].items() if k.startswith("bf16")}
    if len(bf16) != 9 or not all(v.get("HGMMA", 0) > 0
                                 for v in bf16.values()):
        raise AssertionError(f"flash bf16 kernels without HGMMA: {bf16}")
    log("flash kernels (registers, spill bytes, HGMMA in SASS): " + ", ".join(
        f"{k} {v.get('registers')}/{v.get('spill_bytes')}/{v.get('HGMMA')}"
        for k, v in sorted(rep["kernels"].items(),
                           key=lambda kv: (kv[0].split("_")[0],
                                           int(kv[0].split("_")[1]))))
        + f"; wgmma serialized in {rep['serialized']}")
    return rep


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
    card tensors: every output equal and the membranes (and the training
    trace) at 0 ULP, clean and noisy."""
    rs = np.random.RandomState(SEED)
    worst, total_mismatch = 0.0, 0
    cases = [(shape, noisy, how, False)
             for shape in ((ROUND, SLOTS, CFG.n_in, CFG.n_hidden),
                           (32, 64, 512, 128), (32, 37, 300, 200),
                           (ROUND, SLOTS, CFG.n_in, 200),
                           (ROUND, SLOTS, 300, fused_macro.MAX_COLS))
             for noisy, how in ((False, "row_ctl"), (True, "row_ctl"),
                                (True, "scalar"))]
    cases.append(((CFG.n_steps, TRAIN_BATCH, CFG.n_in, CFG.n_hidden), True,
                  "row_ctl", True))
    for (t, m, kdim, n), noisy, how, trace in cases:
        args, nz, noise_kw = _operands(rs, t, m, kdim, n, noisy, dev)
        stream_kw, rc = _streams(rs, m, how, dev)
        kw = dict(k=12, drive_gain=0.25, train_trace=trace, **noise_kw)
        before = fused_macro.fused_macro_seq.launches
        got = ops.fused_macro_seq(*args, nz, device=dev, **stream_kw, **kw)
        torch.cuda.synchronize()
        if fused_macro.fused_macro_seq.launches != before + 1:
            raise AssertionError("ops.fused_macro_seq did not launch the "
                                 "kernel once")
        want = ref.fused_macro_seq_ref(*args, nz, row_ctl=rc, **kw)
        mac_w, v_w, spk_w, mask_w, st_w = want[:5]
        st_w = st_w[..., 0]
        mac_g, v_g, spk_g, mask_g, st_g = got[:5]
        ulps = _ulps(v_g, v_w)
        if trace:
            ulps = max(ulps, _ulps(got[5], want[5]))
        err = (v_g - v_w).abs().max().item()
        worst = max(worst, err)
        mism = int((mask_g != mask_w).sum() + (spk_g != spk_w).sum())
        total_mismatch += mism
        n_el = mask_w.numel()
        tag = (f"T={t} M={m} K={kdim} N={n} "
               f"{'noisy' if noisy else 'clean'} {how}"
               f"{' trace' if trace else ''}")
        log(f"compare {tag}: mask/spike mismatches {mism} of {2 * n_el}, "
            f"steps equal {bool(torch.equal(st_g, st_w))}, mac equal "
            f"{bool(torch.equal(mac_g, mac_w))}, membranes max |err| "
            f"{err:.3g} ({ulps} ulp)")
        if (mism or ulps or not torch.equal(mac_g, mac_w)
                or not torch.equal(st_g, st_w)):
            raise AssertionError(f"{tag}: kernel != plain version")
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
            (32, 37, 300, 50, 3, "sigmoid4"),
            # J*N = 100: no padding, so neuron p's branches on other lanes
            (ROUND, SLOTS, NLD_CFG.n_in, 50, 2, "relu"),
            # J*N = 1024 at the training length
            (NLD_CFG.n_steps, SLOTS, NLD_CFG.n_in, 512, 2, "relu"),
            # more branches than the LIF holds in registers
            (ROUND, 16, 96, 24, 6, "sigmoid4")):
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
        nz = [prbs_lib.sequence_noise(m, t, w, 0.05, dev) for w in widths]
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
            (32, 37, 300, (40, 200, 20), (4, 12, 3)),
            (ROUND, 32, 256, (256,), (12,)),
            (6, 24, 128, (128, 200, 64, 20), (12, 12, 6, 3)),
            # more than the 32 register columns a lane the one-warp-a-row
            # kernel held, which refused it
            (3, 8, 64, (512, 512, 512), (4, 4, 4)),
            (STACK_CFG.n_steps, STACK_BATCH, STACK_CFG.n_in, (1024, 200),
             (24, 12))):
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
            # the hidden layers' spikes (a single layer: its own)
            fired = int(cnt_w[:max(1, len(widths) - 1)].sum())
            log(f"compare {tag}: spike/mask mismatches {mism} of "
                f"{2 * spk_w.numel()}, {same}, membranes {ulps} ulp, "
                f"hidden spikes {fired}, occupied K tiles "
                f"{int(occ_w.sum())}")
            if mism or ulps or not all(same.values()) or not fired:
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
    split: dict = {}
    device_ms = _device_ms_per_launch(launch, 50, split)
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
           "device_ms": device_ms, "device_ms_by_kernel": split,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "bytes": in_bytes + out_bytes, "ops": ops_count,
           "shape": {"R": t, "S": m, "K": kdim, "N": n}}
    log(f"timing R={t} S={m} K={kdim} N={n}: kernel {res['kernel_ms']:.4f} "
        f"ms/round (device {device_ms:.4f} under the profiler), plain "
        f"{res['plain_ms']:.3f} ms/round, bound {bound_ms * 1e3:.3f} us "
        f"({res['bound_by']})")
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
    split: dict = {}
    device_ms = _device_ms_per_launch(launch, 50, split)
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
           "device_ms": device_ms, "device_ms_by_kernel": split,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": in_bytes + out_bytes, "ops": n_ops,
           "shape": {"R": t, "S": m, "K": kdim, "J": nb, "N": n}}
    log(f"NLD timing R={t} S={m} K={kdim} J={nb} N={n}: kernel "
        f"{res['kernel_ms']:.4f} ms/round (device {device_ms:.4f} under "
        f"the profiler), plain {res['plain_ms']:.3f} ms/round, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by})")
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
    split: dict = {}
    device_ms = _device_ms_per_launch(launch, 20, split)
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
           "device_ms": device_ms, "device_ms_by_kernel": split,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": in_bytes + out_bytes, "ops": n_ops,
           "shape": {"T": t, "M": m, "K": kdim, "widths": list(widths)}}
    log(f"stack timing T={t} M={m} K={kdim} widths={widths}: kernel "
        f"{res['kernel_ms']:.4f} ms/launch (device {device_ms:.4f} under "
        f"the profiler), plain {res['plain_ms']:.3f} ms/launch, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by})")
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


# --- silicon training: phases 3, 4 and 5 -------------------------------------

def _close(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.allclose(a, b, **TOL))


def _train_forward(rs, t, m, kdim, n, noisy, dev):
    """A silicon-training forward on the card through the public wrapper
    (the training trace and the MAC residual), the plain version on the
    same card tensors, and random cotangents.  Returns (kernel outputs,
    plain outputs, the backward's residual tuple for
    ``ops.seq_grad_operands``)."""
    args, nz, noise_kw = _operands(rs, t, m, kdim, n, noisy, dev)
    args[0][1::3] = 0.0          # empty steps: row tiles the backward skips
    stream_kw, rc = _streams(rs, m, "scalar", dev)
    kw = dict(k=CFG.k, drive_gain=CFG.drive_gain, train_trace=True,
              **noise_kw)
    got = ops.fused_macro_seq(*args, nz, device=dev, **stream_kw, **kw)
    want = ref.fused_macro_seq_ref(*args, nz, row_ctl=rc, **kw)
    w = 2.0 * args[1].float() + args[2].float()
    g_spk = torch.randn((t, m, n), device=dev)
    g_vfin = torch.randn((m, n), device=dev)
    res = (args[0], w, args[5], got[3], got[5], got[0], g_spk, g_vfin)
    return got, want, res


def compare_train_phase(dev) -> dict:
    """Kernel #1's training trace and kernel #3 against their plain
    versions on the same card tensors, at the training shape (T=30, M=64,
    K=512, N=128) and a padded one (T=7, M=37, K=300, N=100), clean and
    noisy: the trace and dv0 0 ULP, dW within rtol 1e-5 / atol 1e-6, and
    dW / dv0 the same bits run to run, residual or remat, gated or not."""
    rs = np.random.RandomState(SEED + 11)
    torch.manual_seed(SEED + 11)
    worst_trace, worst_dw, n_cases = 0, 0.0, 0
    for t, m, kdim, n in ((CFG.n_steps, TRAIN_BATCH, CFG.n_in,
                           CFG.n_hidden), (7, 37, 300, 100)):
        for noisy in (False, True):
            got, want, res = _train_forward(rs, t, m, kdim, n, noisy, dev)
            same = [torch.equal(a, b[..., 0] if i == 4 else b)
                    for i, (a, b) in enumerate(zip(got, want))]
            ulps = _ulps(got[5], want[5])
            worst_trace = max(worst_trace, ulps)
            tag = (f"T={t} M={m} K={kdim} N={n} "
                   f"{'noisy' if noisy else 'clean'}")
            if not all(same) or ulps:
                raise AssertionError(f"train forward {tag}: kernel != plain "
                                     f"version {same}, vtrace {ulps} ulp")
            first = None
            for remat, gate in ((False, True), (True, True), (False, False),
                                (True, False), (False, True)):
                operands = ops.seq_grad_operands(*res, remat=remat,
                                                 gate=gate)
                before = fused_macro_grad.fused_macro_seq_grad.launches
                dw, dv0 = fused_macro_grad.fused_macro_seq_grad(*operands,
                                                                **GRAD_KW)
                torch.cuda.synchronize()
                if fused_macro_grad.fused_macro_seq_grad.launches \
                        != before + 1:
                    raise AssertionError("the backward wrapper did not "
                                         "launch the kernel once")
                dw_w, dv0_w = ref.fused_macro_seq_grad_ref(*operands,
                                                           **GRAD_KW)
                err = (dw - dw_w).abs().max().item()
                worst_dw = max(worst_dw, err)
                n_cases += 1
                if _ulps(dv0, dv0_w) or not _close(dw, dw_w) \
                        or not dw_w.abs().max() > 0:
                    raise AssertionError(
                        f"backward {tag} remat={remat} gate={gate}: dv0 "
                        f"{_ulps(dv0, dv0_w)} ulp, dW max |err| {err}")
                if first is None:
                    first = (dw, dv0)
                elif not (torch.equal(dw, first[0])
                          and torch.equal(dv0, first[1])):
                    raise AssertionError(f"backward {tag}: dW or dv0 bits "
                                         f"moved (remat={remat}, "
                                         f"gate={gate})")
            log(f"compare train {tag}: forward equal to the plain version, "
                f"vtrace 0 ulp; backward x5 (residual/remat, gated/dense, "
                f"a repeat): dv0 0 ulp, dW within tolerance (max |err| "
                f"{worst_dw:.3g}) and the same bits every launch; "
                f"{int(want[2].sum())} spikes")
    return {"trace": {"max_abs_err": 0.0, "max_ulps": worst_trace,
                      "mismatches": 0, "cases": 4},
            "bwd": {"max_abs_err": worst_dw, "mismatches": 0,
                    "cases": n_cases}}


def _loss_and_grads(params, ev, lab, seed, noise):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    loss = snn.loss_fn(p, ev, lab, CFG, seed, silicon=True, noise=noise,
                       kwn_relax=silicon_lib.DEFAULT_KWN_RELAX)
    grads = torch.autograd.grad(loss, [p["w_hid"], p["w_out"]])
    return loss.detach(), grads


def train_path_phase(dev) -> tuple[dict, dict]:
    """The training path at full width: ``snn.train`` on DVS-Gesture,
    batch 64: 4 software steps, then 8 noise-aware silicon steps warm
    started from them (the fine-tune recipe of
    examples/train_snn_events.py), the launch counters zeroed before and
    read after each.  Then the first silicon step again on the CPU (the
    plain versions) from the same params, batch and seed, and
    ``forward_silicon(fused="step")`` against ``"seq"`` on the card."""
    ds = events_lib.EventDataset(events_lib.DVS_GESTURE, device=dev)
    nm = ima_lib.IMANoiseModel()
    torch.cuda.synchronize()
    reset_counts()
    p_sw, sw_losses = snn.train(CFG, ds, n_steps=SW_STEPS,
                                batch=TRAIN_BATCH, seed=SEED, device=dev)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"the software path launched kernels: "
                             f"{read_counts()}")
    reset_counts()
    t0 = time.perf_counter()
    p_si, si_losses = snn.train(
        CFG, ds, n_steps=SI_STEPS, batch=TRAIN_BATCH, seed=SEED + 1,
        lr=TRAIN_LR, silicon=True, noise=nm,
        kwn_relax=silicon_lib.DEFAULT_KWN_RELAX, params=p_sw, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    fwd = counts.pop("fused_macro_seq_kwn")
    bwd = counts.pop("fused_macro_seq_kwn_bwd")
    if fwd != SI_STEPS or bwd != SI_STEPS or any(counts.values()):
        raise AssertionError(f"silicon steps {SI_STEPS}: forward launches "
                             f"{fwd}, backward {bwd}, others {counts}")
    if not np.isfinite(sw_losses + si_losses).all():
        raise AssertionError(f"non-finite losses {sw_losses} {si_losses}")
    log(f"train path: {SW_STEPS} software steps (losses "
        f"{[round(x, 4) for x in sw_losses]}, no kernel), {SI_STEPS} "
        f"silicon steps (losses {[round(x, 4) for x in si_losses]}); "
        f"seq-KWN launches {fwd} == backward launches {bwd} == steps; "
        f"{1e3 * wall / SI_STEPS:.2f} ms a silicon step with its batch")

    # the first silicon step again, on the card and on the CPU
    batches, step_seeds = snn.train_generators(SEED + 1, dev)
    ev, lab = ds.sample(batches, TRAIN_BATCH)
    seed = silicon_lib.step_seed(step_seeds)
    loss_g, grads_g = _loss_and_grads(p_sw, ev, lab, seed, nm)
    cpu_params = snn.params_to(p_sw, "cpu")
    loss_c, grads_c = _loss_and_grads(cpu_params, ev.cpu(), lab.cpu(), seed,
                                      nm)
    eye = {"w_hid": p_sw["w_hid"],
           "w_out": torch.eye(CFG.n_hidden, device=dev)}
    rates = [silicon_lib.forward_logits(
        snn.params_to(eye, d), ev.to(d), CFG, seed, noise=nm).detach().cpu()
        for d in (dev, torch.device("cpu"))]
    errs = [(a.cpu() - b).abs().max().item()
            for a, b in zip((loss_g,) + grads_g, (loss_c,) + grads_c)]
    if not torch.equal(rates[0], rates[1]) or not rates[1].sum() > 0:
        raise AssertionError("first silicon step: card spikes != CPU spikes")
    if not all(_close(a.cpu(), b) for a, b in
               zip((loss_g,) + grads_g, (loss_c,) + grads_c)):
        raise AssertionError(f"first silicon step: card != CPU, max |err| "
                             f"(loss, w_hid, w_out) {errs}")
    if abs(loss_g.item() - si_losses[0]) > 1e-5 * abs(si_losses[0]):
        raise AssertionError(f"first step loss {loss_g.item()} != "
                             f"{si_losses[0]}")
    log(f"train path: first silicon step on the CPU: spikes equal bit for "
        f"bit ({int(rates[1].sum() * CFG.n_steps)} spikes), loss and "
        f"grads within tolerance, max |err| (loss, w_hid, w_out) {errs}")

    step_res = {}
    for label, noise in (("clean", None), ("noisy", nm)):
        reset_counts()
        ls, ts = snn.forward_silicon(p_si, ev, CFG, seed=seed, noise=noise,
                                     fused="step", device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = counts.pop("fused_macro_seq_kwn")
        lq, tq = snn.forward_silicon(p_si, ev, CFG, seed=seed, noise=noise,
                                     device=dev)
        if launches != CFG.n_steps or any(counts.values()):
            raise AssertionError(f"step path launches {launches}, others "
                                 f"{counts}")
        if not torch.equal(ls, lq) or any(not torch.equal(ts[k], tq[k])
                                          for k in tq):
            raise AssertionError(f"step path {label} != seq path")
        step_res[label] = launches
        log(f"step path {label}: {launches} launches == T, logits and "
            f"telemetry equal to the seq path bit for bit")
    res = {"software_losses": sw_losses, "silicon_losses": si_losses,
           "forward_launches": fwd, "backward_launches": bwd,
           "silicon_wall_s": wall, "first_step_max_abs_err": errs,
           "step_path_launches": step_res}
    return p_si, res


def train_timing_phase(params, dev) -> dict:
    """At the training path's shape (DVS-Gesture batch of 64, T=30,
    K=512, N=128): kernel #3 per launch under both policies against its
    plain version, its bound and one ``torch.matmul`` of the contraction
    alone; kernel #1 with and without its training trace; the whole
    silicon step and its device idle share under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    ds = events_lib.EventDataset(events_lib.DVS_GESTURE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    ev, lab = ds.sample(gen, TRAIN_BATCH)
    nm = ima_lib.IMANoiseModel()
    w, scale = silicon_lib.quantized_weight_ste(params["w_hid"])
    w = w.detach()
    mcfg = macro_lib.CIMMacroConfig(code_bits=CFG.code_bits,
                                    mac_range=CFG.mac_range, ima_noise=nm)
    fw = macro_lib.pack_kwn_weights(w, scale, mcfg)
    kn = macro_lib.fused_kernel_noise(fw, mcfg)
    t, m, kdim, n = CFG.n_steps, TRAIN_BATCH, CFG.n_in, CFG.n_hidden
    x = ev.transpose(0, 1).contiguous()
    plan = fused_macro.plan_tiles(m, kdim, n, n, t)
    if (plan.m_pad, plan.k_pad, plan.n_pad) != (m, kdim, n):
        raise AssertionError(f"training shape is padded: {plan}")
    xi = x.to(torch.int8)
    act = ops.fused_activity_map(xi, plan)
    v0 = torch.zeros((m, n), device=dev)
    rc = macro_lib.stream_row_ctl(
        torch.full((m,), 5, device=dev), torch.zeros(m, device=dev),
        torch.arange(m, device=dev)).contiguous()
    fwd_kw = dict(k=CFG.k, drive_gain=CFG.drive_gain, beta=CFG.beta,
                  v_th1=CFG.v_th1, v_th2=CFG.v_th2, v_lim=8.0,
                  ima_noise=kn, snl_amp=CFG.noise_amp, bm=plan.bm,
                  bk=plan.bk)
    fwd_ops = (xi, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v0,
               None, act, rc)
    fwd_ms = {}
    for trace in (False, True):
        launch = lambda trace=trace: fused_macro.fused_macro_seq(
            *fwd_ops, mac_telemetry=trace, train_trace=trace, **fwd_kw)
        fwd_ms[trace] = [_time_ms(launch, 100) for _ in range(3)]
    fwd_split: dict = {}   # with the trace
    fwd_device_ms = _device_ms_per_launch(launch, 50, fwd_split)
    out = fused_macro.fused_macro_seq(*fwd_ops, mac_telemetry=True,
                                      train_trace=True, **fwd_kw)
    ref_kw = {k: v for k, v in fwd_kw.items() if k not in ("bm", "bk")}
    fwd_plain_ms = [_time_ms(lambda: ref.fused_macro_seq_ref(
        *fwd_ops[:8], row_ctl=rc, mac_telemetry=True, train_trace=True,
        **ref_kw), 2) for _ in range(2)]
    # #1 with its trace: each operand read once (x, planes, codebook,
    # scale, v0, activity, row_ctl), each output written once (v_out; MAC,
    # spikes, mask and trace stacks; steps); the MAC the events need plus
    # the ramp compares (the counter noise's arithmetic is not counted, so
    # the bound is lower than the work)
    n_codes = fw.levels.shape[0]
    fwd_bytes = (xi.numel() + 2 * kdim * n + 4 * (2 * n_codes - 1 + n)
                 + 4 * m * n + 4 * act.numel() + 4 * rc.numel()
                 + 4 * m * n + 4 * 4 * t * m * n + 4 * t * m)
    fwd_ops_n = (2 * int((xi != 0).sum()) * n
                 + t * m * n * (n_codes - 1))
    fwd_bound_ms, fwd_bound_by = _bound(fwd_bytes, fwd_ops_n)
    torch.manual_seed(SEED + 12)
    g_spk = torch.randn((t, m, n), device=dev)
    g_vfin = torch.randn((m, n), device=dev)
    res = (x, w, scale, out[3], out[5], out[0], g_spk, g_vfin)
    timing = {}
    nnz = int((xi != 0).sum())
    for remat in (False, True):
        operands = ops.seq_grad_operands(*res, remat=remat, gate=True)
        launch = lambda operands=operands: \
            fused_macro_grad.fused_macro_seq_grad(*operands, **GRAD_KW)
        plain = lambda operands=operands: ref.fused_macro_seq_grad_ref(
            *operands, **GRAD_KW)
        kernel_ms = [_time_ms(launch, 200) for _ in range(3)]
        plain_ms = [_time_ms(plain, 5) for _ in range(2)]
        device_ms = _device_ms_per_launch(launch, 50)
        # each operand read once, each output written once; the
        # contraction over the events (and the remat MAC) plus the chain
        in_bytes = (xi.numel() + 4 * (3 * t * m * n + m * n + n)
                    + 4 * operands[9].numel()
                    + (2 * kdim * n if remat else 4 * t * m * n))
        out_bytes = 4 * (kdim * n + m * n)
        n_ops = 2 * nnz * n * (2 if remat else 1) + 27 * t * m * n
        bound_ms, bound_by = _bound(in_bytes + out_bytes, n_ops)
        timing["remat" if remat else "residual"] = {
            "kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
            "device_ms": device_ms,
            "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": in_bytes + out_bytes, "ops": n_ops}
    xt = x.reshape(t * m, kdim).t().float().contiguous()
    gm = torch.randn((t * m, n), device=dev)
    library_ms = min(_time_ms(lambda: torch.matmul(xt, gm), 200)
                     for _ in range(3))

    # the whole silicon step (batch drawn beforehand) and its idle share
    p = {k: v.detach().clone() for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}

    def steps(k):
        nonlocal p, mom
        for i in range(k):
            p, mom, loss = snn.train_step(
                p, mom, ev, lab, CFG, TRAIN_LR, 1000 + i, silicon=True,
                noise=nm, kwn_relax=silicon_lib.DEFAULT_KWN_RELAX)
        return loss

    steps(2)
    torch.cuda.synchronize()
    n_steps = 20
    t0 = time.perf_counter()
    steps(n_steps)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(5)
        torch.cuda.synchronize()
    table = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in table if e.device_type == cuda]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / 5
    (ROOT / "chiprun_out" / "chip_smoke_train_profile.txt").write_text(
        table.table(sort_by="self_cpu_time_total", row_limit=40))
    seq_kwn_ms = sum(_device_us(e) for e in kernels
                     if "fmsk" in e.key) / 1e3 / 5
    res = {"bwd": timing, "library_ms": library_ms,
           "fwd_ms": {"trace": min(fwd_ms[True]),
                      "no_trace": min(fwd_ms[False]),
                      "trace_all": fwd_ms[True],
                      "no_trace_all": fwd_ms[False],
                      "device_trace": fwd_device_ms,
                      "device_trace_by_kernel": fwd_split,
                      "plain_trace": min(fwd_plain_ms),
                      "plain_trace_all": fwd_plain_ms,
                      "bound_ms": fwd_bound_ms, "bound_by": fwd_bound_by},
           "seq_kwn_device_ms_per_step": seq_kwn_ms,
           "seq_kwn_device_share": seq_kwn_ms / busy_ms,
           "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / step_ms,
           "top_device": [(e.key, e.count, _device_us(e) / 1e3)
                          for e in sorted(kernels, key=_device_us,
                                          reverse=True)[:8]],
           "shape": {"T": t, "M": m, "K": kdim, "N": n, "nnz": nnz}}
    for pol, tm in timing.items():
        log(f"bwd timing {pol} T={t} M={m} K={kdim} N={n}: kernel "
            f"{tm['kernel_ms']:.4f} ms/launch (device {tm['device_ms']:.4f}"
            f"), plain {tm['plain_ms']:.3f} ms, bound "
            f"{tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']})")
    log(f"contraction alone, torch.matmul (K, T*M) @ (T*M, N): "
        f"{library_ms:.4f} ms; seq-KWN forward at the training shape: "
        f"{res['fwd_ms']['no_trace']:.4f} ms, with trace and MAC "
        f"{res['fwd_ms']['trace']:.4f} ms (device "
        f"{fwd_device_ms:.4f}; plain "
        f"{res['fwd_ms']['plain_trace']:.3f} ms, bound "
        f"{fwd_bound_ms * 1e3:.3f} us ({fwd_bound_by}))")
    log(f"silicon step (batch {m}): {step_ms:.3f} ms, "
        f"{res['steps_per_s']:.1f} steps/s; device busy {busy_ms:.3f} ms a "
        f"step under the profiler (idle share "
        f"{res['device_idle_share']:.3f})")
    for key, count, ms in res["top_device"][:5]:
        log(f"  device {ms:.3f} ms in {count} launches: {key[:80]}")
    log(f"kernels #1 and #3 (fmsk*): {seq_kwn_ms:.4f} ms of device time a "
        f"step, {res['seq_kwn_device_share']:.3f} of it")
    return res


# --- slice 4: the composed chain's four kernels and the composed path --------

LIF_KW = dict(beta=CFG.beta, v_th1=CFG.v_th1, v_th2=CFG.v_th2, v_reset=0.0,
              v_lim=8.0)
STAGE_KERNELS = ("ternary_mac", "nlq_lut", "kwn_topk", "lif_step")
STAGE_SHAPES = ((TRAIN_BATCH, CFG.n_in, CFG.n_hidden),   # the chain's step
                (128, 256, 128),                         # the bench's macro
                (37, 300, 100))                          # ragged
# the edges of #5's split-K tensor-core design: one row, a ragged row tile,
# no K, one and one-and-a-half mma steps, eight slices of 128, a column
# tile of 8, ragged N, 32 column tiles; the stack chain's layer 2
TMAC_EDGES = ((1, 512, 128), (17, 512, 128), (64, 0, 128), (64, 32, 128),
              (64, 48, 128), (64, 1000, 128), (64, 512, 8), (64, 512, 100),
              (64, 512, 1024), (64, 128, 128))
STACK_LAYER2 = (TRAIN_BATCH, 128, 128)


def _tern(rs, shape, density, dev):
    x = rs.choice([-1, 0, 1], p=[density / 2, 1 - density, density / 2],
                  size=shape).astype(np.int8)
    return torch.from_numpy(x).to(dev)


def _stage_codebook(kind, bits):
    if kind == "nlq":
        return ima_lib.nlq_codebook(bits, -24.0, 24.0)
    if kind == "linear":
        return ima_lib.linear_codebook(bits, -24.0, 24.0)
    return ima_lib.activation_codebook(bits, ima_lib.quadratic, -4.0, 4.0)


LARGE_SHAPE = (8192, 1024)    # #6 and #8 at a shape bound by bytes


def _on_card(a: torch.Tensor, dev, offset: int = 0) -> torch.Tensor:
    """``a`` copied to ``dev`` into a contiguous view that starts ``offset``
    elements into a larger buffer (not 16-byte aligned for offset % 4)."""
    buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=dev)
    view = buf[offset:].view(a.shape)
    view.copy_(a)
    return view


def _ramp_edges(rs, bounds, shape, span, dev, offset=0):
    """Values across ``span`` on the card with NaN, +-inf, +-0, every
    boundary and its two f32 neighbours planted at the front."""
    x = rs.uniform(-span, span, shape).astype(np.float32)
    b = bounds.cpu().numpy()
    special = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32), b,
        np.nextafter(b, np.float32(np.inf)),
        np.nextafter(b, np.float32(-np.inf))])
    x.flat[:special.size] = special[:x.size]
    return _on_card(torch.from_numpy(x), dev, offset)


def _lif_operands(rs, shape, dev, offset=0):
    m, n = shape
    return [_on_card(torch.from_numpy(a.astype(np.float32)), dev, offset)
            for a in (rs.uniform(-1.5, 1.5, (m, n)), rs.normal(0, 0.5, (m, n)),
                      rs.uniform(size=(m, n)) < 0.3,
                      0.05 * rs.choice([-1.0, 1.0], size=(m, n)))]


def compare_stage_phase(dev) -> dict:
    """Kernels #5-#8 through their ``ops`` wrappers on the card against
    their plain versions on the same card tensors, at the chain's step
    shape, the bench's macro shape and a ragged one: the MAC at ratios 2,
    3 and 2.05; the ramp at nlq, linear and activation codebooks of 5 and
    6 bits with boundary ties; KWN at k = 0, 1, 12, N and N + 5 on integral
    MACs (ties); the LIF with SNL on and off.  Then #5 at its design's
    edges (``TMAC_EDGES``) at 5 % and 67 % events, ratios 2 and 2.05, and
    #7 with a 6-bit codebook (n_codes 64) at each shape and at N = 1024
    with both codebooks, boundary ties planted.  Then #6 at the edges of
    its design: codebooks of 1, 2 and 8 bits of each kind, permuted 5- and
    8-bit, descending and NaN-holding codebooks (the linear count), NaN,
    +-inf, +-0, every boundary and its f32 neighbours among the inputs, N
    = 100, a total that is not a multiple of 4, operands offset by one
    element (not 16-byte aligned); #8 on views offset by one element; both
    once at ``LARGE_SHAPE``.  Every output exact."""
    rs = np.random.RandomState(SEED + 13)
    res = {name: {"max_abs_err": 0.0, "mismatches": 0, "cases": 0}
           for name in STAGE_KERNELS}

    def check(name, counter, got, want, tag):
        torch.cuda.synchronize()
        if counter.launches != 1:
            raise AssertionError(f"{name} {tag}: {counter.launches} launches")
        counter.launches = 0
        r = res[name]
        r["cases"] += 1
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{name} {tag}: {a.dtype} {a.shape} "
                                     f"!= {b.dtype} {b.shape}")
            mism = int((a != b).sum())
            r["mismatches"] += mism
            if a.is_floating_point():
                r["max_abs_err"] = max(r["max_abs_err"],
                                       (a - b).abs().max().item())
                if _ulps(a, b):
                    raise AssertionError(f"{name} {tag}: {_ulps(a, b)} ulp")
            if mism:
                raise AssertionError(f"{name} {tag}: {mism} mismatches")

    reset_counts()
    for m, kdim, n in STAGE_SHAPES:
        for density in (0.05, 0.67):
            x = _tern(rs, (m, kdim), density, dev)
            msb, lsb = (_tern(rs, (kdim, n), 0.67, dev) for _ in range(2))
            for ratio in (2.0, 3.0, 2.05):
                got = ops.ternary_mac(x, msb, lsb, ratio=ratio, device=dev)
                want = ref.ternary_mac_ref(x, msb, lsb, ratio)
                check("ternary_mac", KERNELS["ternary_mac"], [got], [want],
                      f"M={m} K={kdim} N={n} d={density} ratio={ratio}")
        mac = ops.ternary_mac(x, msb, lsb, device=dev) / 8.0
        KERNELS["ternary_mac"].launches = 0
        mac = torch.round(mac)
        for kind in ("nlq", "linear", "activation"):
            for bits in (5, 6):
                cb = _stage_codebook(kind, bits)
                bounds, levels = cb.boundaries.to(dev), cb.levels.to(dev)
                xin = (mac if kind != "activation"
                       else torch.from_numpy(rs.uniform(-5, 5, (m, n))
                                             .astype(np.float32)).to(dev))
                xin = xin.clone()
                xin.view(-1)[:bounds.numel()] = bounds
                got = ops.nlq_convert(xin, bounds, levels, device=dev)
                check("nlq_lut", KERNELS["nlq_lut"], got,
                      ref.nlq_convert_ref(xin, bounds, levels),
                      f"M={m} N={n} {kind} {bits} bits")
        bounds = ima_lib.nlq_codebook(5, -24.0, 24.0).boundaries.to(dev)
        for k in (0, 1, 12, n, n + 5):
            mask, steps = ops.kwn_topk(mac, bounds, k, device=dev)
            check("kwn_topk", KERNELS["kwn_topk"], [mask, steps[:, None]],
                  ref.kwn_topk_ref(mac, bounds, k), f"M={m} N={n} k={k}")
        for use_snl in (True, False):
            args = _lif_operands(rs, (m, n), dev)
            got = ops.lif_step(*args, use_snl=use_snl, device=dev, **LIF_KW)
            check("lif_step", KERNELS["lif_step"], got,
                  ref.lif_step_ref(*args, use_snl=use_snl, **LIF_KW),
                  f"M={m} N={n} snl={use_snl}")
    for m, kdim, n in TMAC_EDGES:
        msb, lsb = (_tern(rs, (kdim, n), 0.67, dev) for _ in range(2))
        for density in (0.05, 0.67):
            x = _tern(rs, (m, kdim), density, dev)
            for ratio in (2.0, 2.05):
                got = ops.ternary_mac(x, msb, lsb, ratio=ratio, device=dev)
                check("ternary_mac", KERNELS["ternary_mac"], [got],
                      [ref.ternary_mac_ref(x, msb, lsb, ratio)],
                      f"M={m} K={kdim} N={n} d={density} ratio={ratio}")
    kwn_cases = [(m, n, 6) for m, _, n in STAGE_SHAPES] + [
        (TRAIN_BATCH, 1024, 5), (TRAIN_BATCH, 1024, 6)]
    for m, n, bits in kwn_cases:
        bounds = ima_lib.nlq_codebook(bits, -24.0, 24.0).boundaries.to(dev)
        mac = torch.from_numpy(np.round(rs.normal(0, 10, (m, n)))
                               .astype(np.float32)).to(dev)
        mac.view(-1)[:bounds.numel()] = bounds                   # ties
        for k in (0, 1, 12, n, n + 5):
            mask, steps = ops.kwn_topk(mac, bounds, k, device=dev)
            check("kwn_topk", KERNELS["kwn_topk"], [mask, steps[:, None]],
                  ref.kwn_topk_ref(mac, bounds, k),
                  f"M={m} N={n} {bits} bits k={k}")
    cb5 = ima_lib.nlq_codebook(5, -24.0, 24.0)

    def nlq(x, bounds, levels, tag):
        bounds, levels = bounds.to(dev), levels.to(dev)
        check("nlq_lut", KERNELS["nlq_lut"],
              ops.nlq_convert(x, bounds, levels, device=dev),
              ref.nlq_convert_ref(x, bounds, levels), tag)

    for kind in ("nlq", "linear", "activation"):
        span = 5.0 if kind == "activation" else 30.0
        for bits in (1, 2, 8):
            cb = _stage_codebook(kind, bits)
            for shape in ((TRAIN_BATCH, CFG.n_hidden), (5, 101)):
                nlq(_ramp_edges(rs, cb.boundaries, shape, span, dev),
                    cb.boundaries, cb.levels, f"{shape} {kind} {bits} bits")
    cb8 = ima_lib.nlq_codebook(8, -24.0, 24.0)
    unsorted = {"permuted": (cb5, cb5.boundaries[torch.from_numpy(
                    rs.permutation(cb5.boundaries.numel()))]),
                "permuted 8-bit": (cb8, cb8.boundaries[torch.from_numpy(
                    rs.permutation(cb8.boundaries.numel()))]),
                "descending": (cb5, cb5.boundaries.flip(0)),
                "nan": (cb5, cb5.boundaries.clone().index_fill_(
                    0, torch.tensor([7]), float("nan")))}
    for label, (cb, bounds) in unsorted.items():
        nlq(_ramp_edges(rs, cb.boundaries, (TRAIN_BATCH, CFG.n_hidden),
                        30.0, dev), bounds, cb.levels, f"{label} codebook")
    for shape in ((TRAIN_BATCH, CFG.n_hidden), (37, 100)):
        nlq(_ramp_edges(rs, cb5.boundaries, shape, 30.0, dev, offset=1),
            cb5.boundaries, cb5.levels, f"{shape} offset 1")
        for use_snl in (True, False):
            args = _lif_operands(rs, shape, dev, offset=1)
            check("lif_step", KERNELS["lif_step"],
                  ops.lif_step(*args, use_snl=use_snl, device=dev, **LIF_KW),
                  ref.lif_step_ref(*args, use_snl=use_snl, **LIF_KW),
                  f"{shape} offset 1 snl={use_snl}")
    nlq(_ramp_edges(rs, cb5.boundaries, LARGE_SHAPE, 30.0, dev),
        cb5.boundaries, cb5.levels, f"{LARGE_SHAPE}")
    args = _lif_operands(rs, LARGE_SHAPE, dev)
    check("lif_step", KERNELS["lif_step"],
          ops.lif_step(*args, device=dev, **LIF_KW),
          ref.lif_step_ref(*args, **LIF_KW), f"{LARGE_SHAPE}")
    for name, r in res.items():
        log(f"compare {name}: {r['cases']} cases on the card equal to the "
            f"plain version ({r['mismatches']} mismatches, membranes 0 ulp)")
    return res


def _identity(cfg, params):
    """The config and params with an identity readout: the logits are the
    spike rates (counts / T), exactly."""
    cfg_eye = dataclasses.replace(cfg, n_classes=cfg.n_hidden)
    p = dict(params)
    p["w_out"] = torch.eye(cfg.n_hidden, device=params["w_out"].device)
    return cfg_eye, p


def _chain_step(cur, fw, v, noise, k):
    """One step of the four-kernel chain (the bench's ``_composed_step``)
    on ``cur``'s device: MAC, ramp + LUT, KWN, drive ``mac_q * scale *
    mask * gain``, LIF."""
    dev = cur.device
    mac = ops.ternary_mac(cur, fw.msb, fw.lsb, device=dev)
    _, mac_q = ops.nlq_convert(mac, fw.boundaries, fw.levels, device=dev)
    mask, steps = ops.kwn_topk(mac, fw.boundaries, k, device=dev)
    drive = mac_q * fw.scale * mask * CFG.drive_gain
    v, spk = ops.lif_step(v, drive, mask, noise, device=dev, **LIF_KW)
    return v, spk, steps


def _stage_counts() -> tuple[dict, dict]:
    counts = read_counts()
    return {name: counts.pop(name) for name in STAGE_KERNELS}, counts


def composed_path_phase(dev) -> dict:
    """The composed path and the four-kernel chain on the DVS-Gesture KWN
    configuration (64 streams of 30 steps, 5 % events) and its stack, the
    launch counters zeroed before and read after each:
    ``forward_silicon(fused=False)`` (no kernel) against the CPU and
    against ``"seq"``; the chain against ``ops.fused_macro_seq`` and the
    composed forward (30 launches of each kernel); the stack's composed
    forward against the stacked kernel and its chain (8 launches a step)
    against ``ops.fused_macro_multi_seq``; NLD's composed forward against
    the CPU; the noisy composed forward and the Fig. 7 statistics of its
    conversion on the card."""
    rs = np.random.RandomState(SEED + 14)
    b, t = STACK_BATCH, CFG.n_steps
    u = rs.random_sample((b, t, CFG.n_in))
    ev = (u > 0.975).astype(np.float32) - (u < 0.025)
    ev_t = torch.from_numpy(ev).to(dev).transpose(0, 1).contiguous()
    res = {}

    # composed forward: card vs CPU vs "seq", real and identity readouts
    params = snn.init_params(CFG, torch.Generator().manual_seed(SEED),
                             device=dev)
    cfg_eye, p_eye = _identity(CFG, params)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, tele = snn.forward_silicon(params, ev, CFG, fused=False,
                                       device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(read_counts().values()):
        raise AssertionError(f"the composed path launched kernels: "
                             f"{read_counts()}")
    rates, tele_eye = snn.forward_silicon(p_eye, ev, cfg_eye, fused=False,
                                          device=dev)
    lc, tc = snn.forward_silicon(snn.params_to(params, "cpu"), ev, CFG,
                                 fused=False, device="cpu")
    rates_c, _ = snn.forward_silicon(snn.params_to(p_eye, "cpu"), ev,
                                     cfg_eye, fused=False, device="cpu")
    rates_s, tele_s = snn.forward_silicon(p_eye, ev, cfg_eye, fused="seq",
                                          device=dev)
    err = (logits.cpu() - lc).abs().max().item()
    for key in ("adc_steps", "lif_updates", "sops"):
        if not (torch.equal(tele[key].cpu(), tc[key])
                and torch.equal(tele_eye[key], tele_s[key])):
            raise AssertionError(f"composed {key} differs (CPU or seq)")
    if not (torch.equal(rates.cpu(), rates_c) and torch.equal(rates, rates_s)):
        raise AssertionError("composed spike counts differ (CPU or seq)")
    if err > 1e-5 * max(1.0, lc.abs().max().item()) \
            or not torch.isfinite(logits).all() \
            or tuple(logits.shape) != (b, CFG.n_classes):
        raise AssertionError(f"composed logits differ from the CPU by {err}")
    n_spikes = int(round(float(rates.sum()) * t))
    log(f"composed path: {b} x {t} steps on the card, no kernel; spike "
        f"counts ({n_spikes}) and telemetry equal to the CPU and to "
        f"\"seq\" bit for bit, logits within {err:.3g} of the CPU; "
        f"{1e3 * wall:.1f} ms")
    res["composed"] = {"wall_ms": 1e3 * wall, "logits_max_abs_err": err,
                       "spikes": n_spikes,
                       "mean_adc_steps": float(tele["adc_steps"].mean())}

    # the four-kernel chain with the model's planes and PRBS noise
    fw = snn.pack_fused(params, CFG)
    noise = prbs_lib.sequence_noise(b, t, CFG.n_hidden, CFG.noise_amp, dev)
    v0 = torch.zeros((b, CFG.n_hidden), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    v, spikes, steps = v0, [], []
    for step in range(t):
        v, spk, st = _chain_step(ev_t[step], fw, v, noise[step], CFG.k)
        spikes.append(spk)
        steps.append(st)
    torch.cuda.synchronize()
    launches, others = _stage_counts()
    if any(n != t for n in launches.values()) or any(others.values()):
        raise AssertionError(f"chain launches {launches}, others {others}")
    spikes, steps = torch.stack(spikes), torch.stack(steps)
    _, v_f, spk_f, _, st_f = ops.fused_macro_seq(
        ev_t, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v0, noise,
        k=CFG.k, drive_gain=CFG.drive_gain, device=dev)
    if not (torch.equal(spikes, spk_f) and torch.equal(steps, st_f)
            and _ulps(v, v_f) == 0):
        raise AssertionError("chain != ops.fused_macro_seq")
    if not (torch.equal(f32math.div(spikes.sum(0), t), rates)
            and torch.equal(f32math.div(steps.float().sum(0), t),
                            tele["adc_steps"])):
        raise AssertionError("chain != forward_silicon(fused=False)")
    log(f"chain: {t} steps x 4 kernels, launches {launches}; spikes, ADC "
        f"steps and membranes equal to ops.fused_macro_seq bit for bit; "
        f"counts and mean ADC steps equal to the composed forward")
    res["chain"] = {"launches": launches, "spikes": int(spikes.sum())}

    # the stack: composed against the stacked kernel, and its chain
    sparams = snn.init_params(STACK_CFG, torch.Generator().manual_seed(SEED),
                              device=dev)
    scfg_eye, sp_eye = _identity(STACK_CFG, sparams)
    reset_counts()
    rates, tele = snn.forward_silicon(sp_eye, ev, scfg_eye, fused=False,
                                      device=dev)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError("the composed stack launched kernels")
    rates_s, tele_s = snn.forward_silicon(sp_eye, ev, scfg_eye, fused="seq",
                                          device=dev)
    if not torch.equal(rates, rates_s) or any(
            not torch.equal(tele[k], tele_s[k])
            for k in ("adc_steps", "lif_updates", "sops")):
        raise AssertionError("composed stack != stacked kernel")
    stack = snn.pack_fused_stack(sparams, STACK_CFG)
    widths, ks = STACK_CFG.hidden_layers, STACK_CFG.k_layers
    noises = [prbs_lib.sequence_noise(b, t, w, STACK_CFG.noise_amp, dev)
              for w in widths]
    vs0 = [torch.zeros((b, w), device=dev) for w in widths]
    torch.cuda.synchronize()
    reset_counts()
    vs, out, st_layers = list(vs0), [], [[] for _ in widths]
    for step in range(t):
        cur = ev_t[step]
        for li, fwl in enumerate(stack):
            vs[li], cur, st = _chain_step(cur, fwl, vs[li], noises[li][step],
                                          ks[li])
            st_layers[li].append(st)
        out.append(cur)
    torch.cuda.synchronize()
    s_launches, others = _stage_counts()
    want_n = t * len(widths)
    if any(n != want_n for n in s_launches.values()) or any(others.values()):
        raise AssertionError(f"stack chain launches {s_launches}, "
                             f"others {others}")
    mo = ops.fused_macro_multi_seq(
        ev_t, [(f.msb, f.lsb, f.boundaries, f.levels, f.scale)
               for f in stack], vs0, noises, ks=ks,
        drive_gain=STACK_CFG.drive_gain, device=dev)
    out = torch.stack(out)
    if not (torch.equal(out, mo.spikes)
            and all(torch.equal(torch.stack(a), b_)
                    for a, b_ in zip(st_layers, mo.steps))
            and all(_ulps(a, b_) == 0 for a, b_ in zip(vs, mo.v_outs))
            and torch.equal(f32math.div(out.sum(0), t), rates)):
        raise AssertionError("stack chain != stacked kernel / composed")
    log(f"stack: composed forward equal to the stacked kernel (counts and "
        f"telemetry); chain {len(widths) * 4} launches a step, launches "
        f"{s_launches}, equal to ops.fused_macro_multi_seq bit for bit")
    res["stack_chain"] = {"launches": s_launches, "spikes": int(out.sum())}

    # NLD composed: card vs CPU, and the branch-MAC sum order
    nparams = snn.init_params(NLD_CFG, torch.Generator().manual_seed(SEED),
                              device=dev)
    ln, tn = snn.forward_silicon(nparams, ev, NLD_CFG, fused=False,
                                 device=dev)
    lnc, tnc = snn.forward_silicon(snn.params_to(nparams, "cpu"), ev,
                                   NLD_CFG, fused=False, device="cpu")
    nerr = (ln.cpu() - lnc).abs().max().item()
    if any(not torch.equal(tn[k].cpu(), tnc[k]) for k in tn) \
            or not torch.allclose(ln.cpu(), lnc, **TOL) \
            or not torch.isfinite(ln).all():
        raise AssertionError(f"NLD composed: card != CPU (logits {nerr})")
    dp = nparams["dend"]
    w = dp.w_syn * dp.mask
    mac_g = torch.einsum("...i,jin->...jn", ev_t[0], w)
    mac_c = torch.einsum("...i,jin->...jn", ev_t[0].cpu(), w.cpu())
    nld_mism = int((mac_g.cpu() != mac_c).sum())
    log(f"NLD composed: telemetry equal to the CPU, logits within {nerr:.3g};"
        f" branch MACs (64 x 512 against 2 x 512 x 128) differing from the "
        f"CPU's in their last bits: {nld_mism} of {mac_c.numel()}")
    res["nld"] = {"logits_max_abs_err": nerr, "branch_mac_mismatches":
                  nld_mism, "branch_macs": mac_c.numel()}

    # noisy composed KWN, and the Fig. 7 statistics of its conversion
    nm = ima_lib.IMANoiseModel()
    ln, tn = snn.forward_silicon(params, ev, CFG, seed=SEED + 3, noise=nm,
                                 fused=False, device=dev)
    if not torch.isfinite(ln).all() or torch.equal(tn["adc_steps"],
                                                   tc["adc_steps"].to(dev)):
        raise AssertionError("noisy composed forward: not finite, or the "
                             "noise moved no code")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fig7 = ima_lib.measure_transfer_error(ima_lib.nlq_codebook(
        5, -CFG.mac_range, CFG.mac_range), gen, nm, n_points=1 << 20)
    if abs(fig7["mean_lsb"] - 0.41) > 0.06 or abs(fig7["std_lsb"] - 1.34) \
            > 0.08:
        raise AssertionError(f"Fig. 7 statistics on the card: {fig7}")
    log(f"noisy composed: finite, mean ADC steps "
        f"{float(tn['adc_steps'].mean()):.4f} (clean "
        f"{res['composed']['mean_adc_steps']:.4f}); its conversion's code "
        f"error on the card over 2^20 points: mean "
        f"{fig7['mean_lsb']:.4f} LSB, sigma {fig7['std_lsb']:.4f} LSB")
    res["noisy"] = {"fig7": fig7,
                    "mean_adc_steps": float(tn["adc_steps"].mean())}
    return res


def _kernel_name(key: str) -> str:
    """A device event's kernel name without namespaces and arguments."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"^(void )?(\w+::)*", "", head).strip()


def _device_ms_per_launch(fn, reps: int, split: dict | None = None) -> float:
    """Device time per call of ``fn`` under ``torch.profiler`` (every
    device event of ``reps`` calls, over ``reps``): the kernel's own time,
    without the host's launch gaps that CUDA events include.  ``split``,
    when given, receives the ms per call of each device kernel by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(_kernel_name(e.key), _device_us(e) / 1e3 / reps)
              for e in prof.key_averages() if e.device_type == cuda]
    if split is not None:
        for name, ms in events:
            split[name] = split.get(name, 0.0) + ms
    return sum(ms for _, ms in events)


def stage_timing_phase(dev) -> dict:
    """Kernels #5-#8 per launch at the chain's step shape (M=64, K=512,
    N=128, the model's planes, 5 % events) with CUDA events, best of three
    runs of 200 launches, and under the profiler (device time), beside the
    plain version on the card, the bound and one PyTorch call where one
    computes the same function (``torch.matmul`` on decoded f32 weights
    for #5, ``torch.bucketize`` for #6's codes), by both clocks; #5 also
    at 67 % events (``ternary_mac_dense``) and at the stack chain's layer
    2, K = 128 (``ternary_mac_layer2``), and ``torch._int_mm`` on the int8
    events and the two planes side by side (the integer sums only, no
    epilogue) at the step shape; #6 also with its codebook permuted
    (``nlq_lut_unsorted``: the linear count in place of the binary
    search); #6 and #8 at ``LARGE_SHAPE``
    (``_large_cases``); then one chain step against one
    ``ops.fused_macro_step`` launch (both clocks, the chain's device time
    by kernel), the composed forward (30 steps) against ``"seq"``, and the
    card's per-launch floor."""
    rs = np.random.RandomState(SEED + 15)
    m, kdim, n = TRAIN_BATCH, CFG.n_in, CFG.n_hidden
    params = snn.init_params(CFG, torch.Generator().manual_seed(SEED),
                             device=dev)
    fw = snn.pack_fused(params, CFG)
    x = _tern(rs, (m, kdim), 0.05, dev)
    mac = tmac_lib.ternary_mac(x, fw.msb, fw.lsb)
    codes, mac_q = nlq_lib.nlq_convert(mac, fw.boundaries, fw.levels)
    mask, steps = kwn_lib.kwn_topk(mac, fw.boundaries, CFG.k)
    v = torch.from_numpy(rs.uniform(-1, 1, (m, n)).astype(np.float32)) \
        .to(dev)
    drive = mac_q * fw.scale * mask * CFG.drive_gain
    noise = prbs_lib.sequence_noise(m, 1, n, CFG.noise_amp, dev)[0]
    n_codes = fw.levels.numel()
    nnz = int((x != 0).sum())
    w_f = 2.0 * fw.msb.float() + fw.lsb.float()
    x_f = x.float()
    x_dense = _tern(rs, (m, kdim), 0.67, dev)
    x_dense_f = x_dense.float()
    m2, k2, n2 = STACK_LAYER2
    x2 = _tern(rs, (m2, k2), 0.05, dev)
    msb2, lsb2 = (_tern(rs, (k2, n2), 0.67, dev) for _ in range(2))
    w2_f = 2.0 * msb2.float() + lsb2.float()
    x2_f = x2.float()
    perm = fw.boundaries[torch.from_numpy(np.random.RandomState(
        SEED + 17).permutation(n_codes - 1)).to(dev)]
    cases = {
        "ternary_mac": (
            lambda: tmac_lib.ternary_mac(x, fw.msb, fw.lsb),
            lambda: ref.ternary_mac_ref(x, fw.msb, fw.lsb),
            lambda: torch.matmul(x_f, w_f),
            x.numel() + 2 * kdim * n + 4 * m * n, 2 * 2 * nnz * n, INT8_OPS),
        "ternary_mac_dense": (
            lambda: tmac_lib.ternary_mac(x_dense, fw.msb, fw.lsb),
            lambda: ref.ternary_mac_ref(x_dense, fw.msb, fw.lsb),
            lambda: torch.matmul(x_dense_f, w_f),
            x.numel() + 2 * kdim * n + 4 * m * n,
            2 * 2 * int((x_dense != 0).sum()) * n, INT8_OPS),
        "ternary_mac_layer2": (
            lambda: tmac_lib.ternary_mac(x2, msb2, lsb2),
            lambda: ref.ternary_mac_ref(x2, msb2, lsb2),
            lambda: torch.matmul(x2_f, w2_f),
            x2.numel() + 2 * k2 * n2 + 4 * m2 * n2,
            2 * 2 * int((x2 != 0).sum()) * n2, INT8_OPS),
        "nlq_lut": (
            lambda: nlq_lib.nlq_convert(mac, fw.boundaries, fw.levels),
            lambda: ref.nlq_convert_ref(mac, fw.boundaries, fw.levels),
            lambda: torch.bucketize(mac, fw.boundaries),
            4 * m * n + 4 * (2 * n_codes - 1) + 2 * 4 * m * n,
            m * n * (n_codes - 1), F32_FLOPS),
        "nlq_lut_unsorted": (
            lambda: nlq_lib.nlq_convert(mac, perm, fw.levels),
            lambda: ref.nlq_convert_ref(mac, perm, fw.levels),
            None, 4 * m * n + 4 * (2 * n_codes - 1) + 2 * 4 * m * n,
            m * n * (n_codes - 1), F32_FLOPS),
        "kwn_topk": (
            lambda: kwn_lib.kwn_topk(mac, fw.boundaries, CFG.k),
            lambda: ref.kwn_topk_ref(mac, fw.boundaries, CFG.k),
            None,
            4 * m * n + 4 * (n_codes - 1) + 4 * m * n + 4 * m,
            m * n * (n_codes - 1) + n * int((steps + 1).sum()), F32_FLOPS),
        "lif_step": (
            lambda: lif_lib.lif_step_fused(v, drive, mask, noise, **LIF_KW),
            lambda: ref.lif_step_ref(v, drive, mask, noise, **LIF_KW),
            None, 4 * 4 * m * n + 2 * 4 * m * n, 8 * m * n, F32_FLOPS)}
    cases.update(_large_cases(dev))
    if not torch.equal(torch.bucketize(mac, fw.boundaries).int(), codes):
        raise AssertionError("torch.bucketize is not the ramp's code")
    res = {}
    for name, (launch, plain, library, n_bytes, n_ops, peak) in \
            cases.items():
        device_ms = _device_ms_per_launch(launch, 200)
        kernel_ms = [_time_ms(launch, 200) for _ in range(3)]
        plain_ms = [_time_ms(plain, 20) for _ in range(2)]
        lib_ms = None if library is None else min(
            _time_ms(library, 200) for _ in range(3))
        lib_device_ms = (None if library is None
                         else _device_ms_per_launch(library, 200))
        bytes_s, ops_s = n_bytes / HBM_BYTES_PER_S, n_ops / peak
        res[name] = {"kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
                     "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_device_ms,
                     "device_ms": device_ms,
                     "bound_ms": 1e3 * max(bytes_s, ops_s),
                     "bound_by": "bytes" if bytes_s >= ops_s
                     else "operations", "bytes": n_bytes, "ops": n_ops,
                     # nan where the profiler dropped the kernel's events
                     "bound_share": (1e3 * max(bytes_s, ops_s) / device_ms
                                     if device_ms else float("nan"))}
        sm, sk, sn = STACK_LAYER2 if name == "ternary_mac_layer2" else (
            m, kdim, n)
        shape = (f"M={LARGE_SHAPE[0]} N={LARGE_SHAPE[1]}" if "_large" in name
                 else f"M={sm} K={sk} N={sn}")
        log(f"{name} timing {shape}: kernel "
            f"{res[name]['kernel_ms']:.4f} ms/launch (device "
            f"{device_ms:.4f} ms under the profiler), plain "
            f"{res[name]['plain_ms']:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} (device "
            f"{'none' if lib_device_ms is None else f'{lib_device_ms:.4f}'})"
            f", bound "
            f"{res[name]['bound_ms'] * 1e3:.4f} us ({res[name]['bound_by']},"
            f" {n_bytes} B), {res[name]['bound_share']:.4f} of it on the "
            f"device")

    # the integer sums alone on PyTorch's int8 product, both planes at once
    planes = torch.cat([fw.msb, fw.lsb], dim=1)
    int_mm = lambda: torch._int_mm(x, planes)
    res["int_mm_ms"] = min(_time_ms(int_mm, 200) for _ in range(3))
    res["int_mm_device_ms"] = _device_ms_per_launch(int_mm, 200)
    log(f"torch._int_mm (M={m}, K={kdim}, 2N={2 * n}, int32 sums only): "
        f"{res['int_mm_ms']:.4f} ms (device {res['int_mm_device_ms']:.4f})")

    # one chain step against one fused step launch, on the same operands
    v0 = torch.zeros((m, n), device=dev)
    chain = lambda: _chain_step(x, fw, v0, noise, CFG.k)
    fused = lambda: ops.fused_macro_step(
        x, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v0, noise,
        k=CFG.k, drive_gain=CFG.drive_gain, mac_telemetry=False, device=dev)
    res["chain_step_ms"] = min(_time_ms(chain, 200) for _ in range(3))
    res["fused_step_ms"] = min(_time_ms(fused, 200) for _ in range(3))
    split: dict = {}
    res["chain_step_device_ms"] = _device_ms_per_launch(chain, 200, split)
    res["chain_step_device_by_kernel"] = split
    res["fused_step_device_ms"] = _device_ms_per_launch(fused, 200)
    u = rs.random_sample((m, CFG.n_steps, kdim))
    ev = (u > 0.975).astype(np.float32) - (u < 0.025)
    for label, fz in (("composed", False), ("seq", "seq")):
        run = lambda fz=fz: snn.forward_silicon(params, ev, CFG, fused=fz,
                                                device=dev)
        res[f"{label}_forward_ms"] = min(_time_ms(run, 3) for _ in range(3))
    log(f"chain step (4 kernels + the drive) {res['chain_step_ms']:.4f} ms "
        f"(device {res['chain_step_device_ms']:.4f}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f") against one fused step launch {res['fused_step_ms']:.4f} ms "
        f"(device {res['fused_step_device_ms']:.4f}); "
        f"forward_silicon at batch {m}, {CFG.n_steps} steps: composed "
        f"{res['composed_forward_ms']:.2f} ms, seq "
        f"{res['seq_forward_ms']:.3f} ms")
    res["floor"] = launch_floor(dev)
    return res


def launch_floor(dev) -> dict:
    """The per-launch floor of the card, a yardstick the port never calls:
    ``zero_()`` of a one-element tensor, its device time under the
    profiler and its CUDA-event time (best of three runs of 200)."""
    z = torch.zeros(1, device=dev)
    fill = lambda: z.zero_()
    res = {"device_ms": _device_ms_per_launch(fill, 200),
           "event_ms": min(_time_ms(fill, 200) for _ in range(3))}
    log(f"launch floor (zero_ of one element): device "
        f"{res['device_ms']:.4f} ms, CUDA events {res['event_ms']:.4f} ms")
    return res


def _large_cases(dev) -> dict:
    """#6 and #8 at ``LARGE_SHAPE``, where bytes and not the launch set the
    pace (100-200 MB of operands, beyond the 50 MB L2), in
    ``stage_timing_phase``'s form: #6 at the model's 5-bit codebook and at
    6 bits, each also permuted (``_unsorted``: the linear count in place of
    the binary search), beside ``torch.bucketize`` (the codes only) on the
    sorted ones; #8 with SNL."""
    rs = np.random.RandomState(SEED + 16)
    m, n = LARGE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.round(10.0 * torch.randn((m, n), generator=gen, device=dev))
    v, drive, noise = (torch.randn((m, n), generator=gen, device=dev) * sd
                       for sd in (1.0, 0.5, 0.05))
    mask = (torch.rand((m, n), generator=gen, device=dev) < 0.3).float()
    cases = {}
    for bits, label in ((5, ""), (6, "_6bit")):
        cb = ima_lib.nlq_codebook(bits, -CFG.mac_range, CFG.mac_range)
        b, lv = cb.boundaries.to(dev), cb.levels.to(dev)
        perm = b[torch.from_numpy(rs.permutation(b.numel())).to(dev)]
        for name, bounds, library in (
                (f"nlq_lut_large{label}", b,
                 lambda b=b: torch.bucketize(x, b)),
                (f"nlq_lut_large{label}_unsorted", perm, None)):
            cases[name] = (
                lambda bounds=bounds, lv=lv: nlq_lib.nlq_convert(x, bounds,
                                                                 lv),
                lambda bounds=bounds, lv=lv: ref.nlq_convert_ref(x, bounds,
                                                                 lv),
                library, 12 * m * n + 4 * (2 * lv.numel() - 1),
                m * n * (lv.numel() - 1), F32_FLOPS)
    cases["lif_step_large"] = (
        lambda: lif_lib.lif_step_fused(v, drive, mask, noise, **LIF_KW),
        lambda: ref.lif_step_ref(v, drive, mask, noise, **LIF_KW),
        None, 24 * m * n, 8 * m * n, F32_FLOPS)
    return cases


# --- slice 5: the dense LM path and kernel #9 (flash attention) --------------

LM_ARCH = "smollm-135m"
PREFILL_BATCH, PREFILL_LEN = 8, 2048     # SmolLM's published context
DECODE_TO, DECODE_STEPS = 2080, 32
CONSIST_BATCH, CONSIST_LEN = 2, 64
# prefill against teacher-forced decode: the JAX suite's 2e-3 in f32; in
# bf16 the two paths round activations at other places (the kernel keeps
# scores in f32, decode's einsums round them to bf16), which moved logits
# of magnitude ~2.5 by 0.043 on the card (64 tokens, batch 2); BF16_TOL
# leaves a factor of about 3 over that
F32_TOL, BF16_TOL = 2e-3, 0.125
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_DIMS, FLASH_SEQS = (16, 32, 64, 128), (128, 192, 1000, 2048)
# the head dims of reduced configs (21) and of the registry (80, 112, 192,
# 256), padded inside the kernel's tiles, at fewer lengths
FLASH_PADDED_DIMS, FLASH_PADDED_SEQS = (21, 80, 112, 192, 256), (192, 1000)
FLASH_CASES = ([(d, s) for d in FLASH_DIMS for s in FLASH_SEQS]
               + [(d, s) for d in FLASH_PADDED_DIMS
                  for s in FLASH_PADDED_SEQS] + [(256, 2048)])
LM_HEADS = 72                           # BH of the smollm prefill: 8 x 9
# (BH, S, D) of the phase-5 timings: the smollm prefill's attention at its
# context and at 512, and gemma2's head_dim
FLASH_TIMED = ((LM_HEADS, 2048, 64), (LM_HEADS, 512, 64), (16, 2048, 256))
FLASH_MAIN = "72x2048x64"


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ULP at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_flash_phase(dev) -> dict:
    """Kernel #9 against its plain version on the same card tensors: f32
    and bf16, causal and full, ``FLASH_CASES`` (D from 16 to 256, S in
    128, 192, 1000 (ragged) and 2048), BH 72 at D = 64 (the smollm
    prefill) and 12 otherwise; f32
    within rtol = atol = 2e-5, bf16 against the plain version's f32 result
    rounded, within one bf16 ULP (or 2e-5 where an output cancels to near
    zero); then the large-logit case (inputs x30, integer-valued so the
    scores are exact in any sum order) at the f32 tolerance."""
    rs = np.random.RandomState(SEED + 20)
    res = {"cases": 0, "mismatches": 0, "max_abs_err": 0.0,
           "max_abs_err_bf16": 0.0, "max_bf16_ulps": 0.0}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for d, s in FLASH_CASES:
                bh = LM_HEADS if d == 64 else 12
                q, k, v = (torch.from_numpy(
                    rs.randn(bh, s, d).astype(np.float32)).to(dev, dtype)
                    for _ in range(3))
                got = flash_lib.flash_attention_fwd(q, k, v,
                                                    causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal)
                torch.cuda.synchronize()
                g, w = got.float(), want.float()
                err = (g - w).abs()
                case = f"{dtype} causal={causal} D={d} S={s} BH={bh}"
                if got.dtype != dtype or not torch.isfinite(g).all():
                    raise AssertionError(f"flash {case}: bad output")
                if dtype == torch.float32:
                    if not torch.allclose(got, want, **FLASH_TOL):
                        raise AssertionError(
                            f"flash {case}: max err {err.max():.3g}")
                    res["max_abs_err"] = max(res["max_abs_err"],
                                             float(err.max()))
                else:
                    ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
                    if not (err <= torch.clamp(ulp, min=2e-5)).all():
                        raise AssertionError(
                            f"flash {case}: beyond one bf16 ULP")
                    res["max_abs_err_bf16"] = max(
                        res["max_abs_err_bf16"], float(err.max()))
                    # in ULPs where an ULP is the tolerance
                    big = ulp >= 2e-5
                    if big.any():
                        res["max_bf16_ulps"] = max(
                            res["max_bf16_ulps"],
                            float((err[big] / ulp[big]).max()))
                res["cases"] += 1
    for d, s in ((16, 128), (21, 1000), (64, 1000), (64, 2048), (256, 1000)):
        q, k, v = (torch.round(30.0 * torch.from_numpy(
            rs.randn(8, s, d).astype(np.float32))).to(dev) for _ in range(3))
        got = flash_lib.flash_attention_fwd(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, True)
        if not torch.isfinite(got).all() or not torch.allclose(
                got, want, **FLASH_TOL):
            raise AssertionError(f"flash large logits D={d} S={s}: max err "
                                 f"{(got - want).abs().max():.3g}")
        res["max_abs_err_large"] = max(res.get("max_abs_err_large", 0.0),
                                       float((got - want).abs().max()))
        res["cases"] += 1
    log(f"flash_attention: {res['cases']} cases equal to the plain version "
        f"(f32 max abs err {res['max_abs_err']:.3g}, large logits "
        f"{res['max_abs_err_large']:.3g}; bf16 max abs err "
        f"{res['max_abs_err_bf16']:.3g}, {res['max_bf16_ulps']:.2f} ULP) "
        f"in {time.perf_counter() - t0:.1f} s")
    return res


def _lm_counts() -> tuple[int, dict]:
    counts = read_counts()
    return counts.pop("flash_attention"), counts


def _greedy_reference(params, cfg, prompt, n_new, dev):
    """What the engine should generate for ``prompt`` alone (batch 1):
    prefill, then greedy decode.  The engine feeds the argmax after the
    prompt without recording it, so this returns n_new + 1 tokens and the
    top-2 logit gap at each."""
    toks = torch.tensor([prompt], device=dev)
    logits, _, cache = lm.forward(params, {"tokens": toks}, cfg,
                                  prefill=True)
    cache = lm.pad_cache(cache, cfg, len(prompt) + n_new + 1)
    seq, gaps = [], []
    for i in range(n_new + 1):
        top2 = torch.topk(logits[0, :cfg.vocab_size], 2)
        seq.append(int(top2.indices[0]))
        gaps.append(float(top2.values[0] - top2.values[1]))
        if i == n_new:
            break
        logits, cache = lm.decode_step(
            params, cache, torch.tensor([[seq[-1]]], device=dev),
            torch.tensor([len(prompt) + i], device=dev), cfg)
    return seq, gaps


def _check_against_reference(params, cfg, done, tol, dev) -> int:
    """Each request's tokens equal the reference's wherever every top-2
    gap up to that token exceeds ``tol``; returns the near ties seen."""
    near_ties = 0
    for r in done:
        seq, gaps = _greedy_reference(params, cfg, r.prompt,
                                      len(r.generated), dev)
        for i, tok in enumerate(r.generated):
            if tok != seq[i + 1]:
                if min(gaps[:i + 2]) > tol:
                    raise AssertionError(
                        f"request {r.uid}: token {i} is {tok}, the "
                        f"reference's {seq[i + 1]}, with every top-2 gap "
                        f"above {tol} (min {min(gaps[:i + 2]):.4g})")
                near_ties += 1
                break
    return near_ties


def lm_path_phase(dev) -> tuple[dict, dict]:
    """smollm-135m at full width (30 layers, d_model 576, 9 heads over 3
    kv heads, d_ff 1536, vocab 49152, tied embeddings, bf16 compute),
    random weights from the seed, each step with the counters zeroed just
    before and read just after: prefill of 8 x 2048 tokens (30 flash
    launches), ``pad_cache`` to 2080 and 32 greedy decode steps (none);
    prefill against teacher-forced decode over 64 tokens in f32 and bf16;
    ``launch/serve.py``'s CLI with its defaults (8 requests, 4 slots, 12
    new tokens, s_max 128, prompts of 4-7 tokens; no flash launch), its
    tokens against a prefill-plus-decode run of each prompt; the same
    engine in CIM mode."""
    cfg = configs.get_config(LM_ARCH)
    params = nn_module.materialize(lm.param_specs(cfg),
                                   torch.Generator().manual_seed(SEED),
                                   device=dev)
    rs = np.random.RandomState(SEED + 21)
    toks = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))).to(dev)
    res: dict = {"arch": LM_ARCH, "params": cfg.param_count()}
    t_phase = time.perf_counter()

    reset_counts()
    t0 = time.perf_counter()
    logits, _, cache = lm.forward(params, {"tokens": toks}, cfg,
                                  prefill=True)
    torch.cuda.synchronize()
    flash, others = _lm_counts()
    res["prefill"] = {"launches": flash, "wall_ms_first": 1e3 * (
        time.perf_counter() - t0)}
    if flash != cfg.n_layers or any(others.values()):
        raise AssertionError(f"prefill: {flash} flash launches for "
                             f"{cfg.n_layers} layers, others {others}")
    if tuple(logits.shape) != (PREFILL_BATCH, cfg.padded_vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    cache = lm.pad_cache(cache, cfg, DECODE_TO)
    if tuple(cache["b0"]["k"].shape) != (cfg.n_groups, PREFILL_BATCH,
                                         DECODE_TO, cfg.n_kv, cfg.hd):
        raise AssertionError(f"padded cache {cache['b0']['k'].shape}")
    reset_counts()
    nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    generated = []
    for i in range(DECODE_STEPS):
        pos = torch.full((PREFILL_BATCH,), PREFILL_LEN + i, device=dev)
        logits, cache = lm.decode_step(params, cache, nxt[:, None], pos,
                                       cfg)
        nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        generated.append(nxt)
    torch.cuda.synchronize()
    flash, others = _lm_counts()
    if flash or any(others.values()) or not torch.isfinite(logits).all():
        raise AssertionError(f"decode: flash {flash}, others {others}")
    res["decode"] = {"steps": DECODE_STEPS, "launches": flash}
    log(f"LM prefill {PREFILL_BATCH} x {PREFILL_LEN}: "
        f"{res['prefill']['launches']} flash launches, logits "
        f"{tuple(logits.shape)} finite; {DECODE_STEPS} greedy decode steps "
        f"to {PREFILL_LEN + DECODE_STEPS} of {DECODE_TO} slots, no launch")

    res["consistency"] = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        c = dataclasses.replace(cfg, dtype=dtype)
        tk = toks[:CONSIST_BATCH, :CONSIST_LEN]
        reset_counts()
        lp, _, pc = lm.forward(params, {"tokens": tk}, c, prefill=True)
        torch.cuda.synchronize()
        flash, _ = _lm_counts()
        dc = lm.init_cache(c, CONSIST_BATCH, CONSIST_LEN, device=dev)
        for t in range(CONSIST_LEN):
            ld, dc = lm.decode_step(params, dc, tk[:, t:t + 1],
                                    torch.full((CONSIST_BATCH,), t,
                                               device=dev), c)
        err = float((ld - lp).abs().max())
        kerr = max(float((dc[n][key].float() - pc[n][key].float())
                         .abs().max()) for n in pc for key in ("k", "v"))
        res["consistency"][dtype] = {"max_abs_err_logits": err,
                                     "max_abs_err_cache": kerr,
                                     "tol": tol, "launches": flash,
                                     "logit_scale": float(lp.abs().max())}
        log(f"prefill vs teacher-forced decode over {CONSIST_LEN} tokens "
            f"({dtype}): logits max abs err {err:.3g} (tol {tol}; max "
            f"|logit| {res['consistency'][dtype]['logit_scale']:.3g}), "
            f"cache {kerr:.3g}, {flash} flash launches")
        if flash != cfg.n_layers or not torch.allclose(ld, lp, rtol=tol,
                                                       atol=tol):
            raise AssertionError(f"prefill vs decode ({dtype}): {err:.3g}")

    reset_counts()
    t0 = time.perf_counter()
    done = serve_lib.main(["--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash, others = _lm_counts()
    if flash or any(others.values()):
        raise AssertionError(f"serving: flash {flash}, others {others}")
    if len(done) != 8 or any(len(r.generated) != 12 or not all(
            0 <= t < cfg.vocab_size for t in r.generated) for r in done):
        raise AssertionError("serving: not every request completed with 12 "
                             "tokens in the vocabulary")
    near = _check_against_reference(params, cfg, done, 2 * BF16_TOL, dev)
    # the same requests in f32, where the tolerance is tight enough that a
    # near tie is rare on a random model's flat logits
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    eng = engine_lib.BatchedEngine(f32_cfg, params, batch_slots=4,
                                   s_max=128, device=dev)
    for r in done:
        eng.submit(engine_lib.Request(uid=r.uid, prompt=r.prompt,
                                      max_new_tokens=12))
    reset_counts()
    f32_done = eng.run(max_rounds=256)
    flash, others = _lm_counts()
    if len(f32_done) != 8 or flash or any(others.values()):
        raise AssertionError(f"f32 serving: {len(f32_done)} done, flash "
                             f"{flash}, others {others}")
    near32 = _check_against_reference(params, f32_cfg, f32_done,
                                      2 * F32_TOL, dev)
    res["serving"] = {"requests": len(done), "launches": flash,
                      "wall_s_first": wall, "near_ties_bf16": near,
                      "near_ties_f32": near32,
                      "tokens": {r.uid: r.generated for r in done}}
    log(f"launch.serve defaults: {len(done)} requests x 12 tokens, 0 flash "
        f"launches; tokens equal prefill + decode of each prompt except "
        f"{near} near ties (top-2 gap <= {2 * BF16_TOL}); in f32 "
        f"{near32} (gap <= {2 * F32_TOL})")

    cim_cfg = dataclasses.replace(cfg, cim_linear=True)
    eng = engine_lib.BatchedEngine(cim_cfg, params, batch_slots=4,
                                   s_max=128, device=dev)
    step, finite = eng.step_fn, []

    def checked_step(*args):
        nxt, logits, cache = step(*args)
        finite.append(torch.isfinite(logits).all())
        return nxt, logits, cache

    eng.step_fn = checked_step
    for r in done:
        eng.submit(engine_lib.Request(uid=r.uid, prompt=r.prompt,
                                      max_new_tokens=12))
    reset_counts()
    cim_done = eng.run(max_rounds=256)
    flash, others = _lm_counts()
    if len(cim_done) != 8 or any(len(r.generated) != 12 for r in cim_done) \
            or not bool(torch.stack(finite).all()) or flash \
            or any(others.values()):
        raise AssertionError("CIM-mode engine did not complete cleanly")
    res["cim_serving"] = {"requests": len(cim_done), "steps": len(finite),
                          "launches": flash}
    log(f"CIM-mode engine: {len(cim_done)} requests x 12 tokens, finite "
        f"logits at all {len(finite)} steps; LM path "
        f"{time.perf_counter() - t_phase:.1f} s")
    return params, res


FAULT_S_MAX, FAULT_PROMPTS, FAULT_NEW = 8, (7, 8, 9), 4
WIDE_HEAD_ARCH, WIDE_HEAD_D_MODEL = "nemotron-4-340b", 768   # head_dim 192


def lm_fault_phase(dev) -> dict:
    """The two faults this slice repairs, on the card, each with the
    counters zeroed just before and read just after.  ``BatchedEngine`` on
    the reduced smollm-135m (1 slot, s_max 8, 4 new tokens) with prompts
    of 7, 8 and 9 tokens: the token-by-token prefill and the decode reach
    and pass s_max, where the reference writes no K/V; the run must not
    assert on the device and must give the tokens of the same engine on
    the CPU.  Then a prefill of nemotron-4-340b reduced to d_model 768
    over 4 heads (its own head_dim, 192) through the flash kernel: one
    launch a layer, logits equal to the CPU's within 1e-5 in f32."""
    res: dict = {"engine": {}}
    cfg = config_base.reduced(configs.get_config(LM_ARCH))
    p_cpu = nn_module.materialize(lm.param_specs(cfg),
                                  torch.Generator().manual_seed(SEED + 1),
                                  device="cpu")
    p_gpu = nn_module.tree_map(lambda t: t.to(dev), p_cpu)
    rs = np.random.RandomState(SEED + 23)
    for n in FAULT_PROMPTS:
        prompt = [int(t) for t in rs.randint(0, cfg.vocab_size, n)]
        tokens = {}
        for where, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            eng = engine_lib.BatchedEngine(cfg, params, batch_slots=1,
                                           s_max=FAULT_S_MAX,
                                           device=dev if where == "cuda"
                                           else "cpu")
            eng.submit(engine_lib.Request(uid=0, prompt=prompt,
                                          max_new_tokens=FAULT_NEW))
            reset_counts()
            done = eng.run()
            torch.cuda.synchronize()          # a device assert shows here
            if any(read_counts().values()):
                raise AssertionError(f"engine at s_max: {read_counts()}")
            tokens[where] = [r.generated for r in done]
        if tokens["cuda"] != tokens["cpu"] or not tokens["cuda"][0]:
            raise AssertionError(f"engine, {n}-token prompt, s_max "
                                 f"{FAULT_S_MAX}: card {tokens['cuda']}, "
                                 f"CPU {tokens['cpu']}")
        res["engine"][n] = tokens["cuda"][0]

    wide = config_base.reduced(configs.get_config(WIDE_HEAD_ARCH),
                               d_model=WIDE_HEAD_D_MODEL)
    p_cpu = nn_module.materialize(lm.param_specs(wide),
                                  torch.Generator().manual_seed(SEED + 2),
                                  device="cpu")
    p_gpu = nn_module.tree_map(lambda t: t.to(dev), p_cpu)
    toks = torch.from_numpy(rs.randint(0, wide.vocab_size, (2, 300)))
    reset_counts()
    got, _, _ = lm.forward(p_gpu, {"tokens": toks.to(dev)}, wide,
                           prefill=True)
    torch.cuda.synchronize()
    flash, others = _lm_counts()
    want, _, _ = lm.forward(p_cpu, {"tokens": toks}, wide, prefill=True)
    err = float((got.cpu() - want).abs().max())
    if flash != wide.n_layers or any(others.values()) or not torch.allclose(
            got.cpu(), want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"head_dim {wide.hd} prefill: {flash} flash "
                             f"launches for {wide.n_layers} layers, others "
                             f"{others}, max err {err:.3g}")
    res["wide_head"] = {"arch": WIDE_HEAD_ARCH, "head_dim": wide.hd,
                        "launches": flash, "max_abs_err": err}
    log(f"BatchedEngine at s_max {FAULT_S_MAX} (prompts "
        f"{list(FAULT_PROMPTS)} tokens): no device assert, tokens equal to "
        f"the CPU's {res['engine']}; {WIDE_HEAD_ARCH} reduced to head_dim "
        f"{wide.hd}: prefill {flash} flash launches, logits within "
        f"{err:.3g} of the CPU's")
    return res


def _is_flash(key: str) -> bool:
    return "flash_bf16_kernel" in key or "flash_f32_kernel" in key


def _device_busy_ms(prof) -> float:
    """Device time of every kernel and copy in a profile, summed from the
    raw trace: ``key_averages`` spends a minute or more on the ~10^6
    events of an engine run."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6


def lm_timing_phase(params, dev) -> dict:
    """Kernel #9 (bf16, causal) at ``FLASH_TIMED``: ms per launch through
    the wrapper (CUDA events, best of three runs) and the
    device ms under the profiler, the plain version, the bound and
    ``scaled_dot_product_attention`` (timed only; the port never calls
    it); prefill ms for 8 x 2048 and the kernel's share of device time;
    a decode step at batch 8 against a 2080-slot cache; ``BatchedEngine``
    tokens/s with the launch/serve defaults, and its device idle share."""
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get_config(LM_ARCH)
    rs = np.random.RandomState(SEED + 22)
    res: dict = {"flash": {}}
    t_phase = time.perf_counter()
    for bh, s, d in FLASH_TIMED:
        q, k, v = (torch.from_numpy(rs.randn(bh, s, d).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3))
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        launch = lambda: flash_lib.flash_attention_fwd(q, k, v, causal=True)
        plain = lambda: ref.flash_attention_ref(q, k, v, True)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        reps = 20 if s == 2048 else 100
        kernel_ms = [_time_ms(launch, reps) for _ in range(3)]
        device_ms = _device_ms_per_launch(launch, reps)
        plain_ms = [_time_ms(plain, 5) for _ in range(2)]
        lib_ms = [_time_ms(library, 5 * reps) for _ in range(3)]
        n_bytes = 4 * bh * s * d * 2
        n_ops = 4 * bh * d * (s * s + s) // 2
        bytes_s, ops_s = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS
        lib_err = float((library().reshape(bh, s, d).float()
                         - launch().float()).abs().max())
        key = f"{bh}x{s}x{d}"
        res["flash"][key] = {
            "kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
            "device_ms": device_ms, "plain_ms": min(plain_ms),
            "plain_ms_all": plain_ms, "library_ms": min(lib_ms),
            "library_ms_all": lib_ms, "library_max_abs_diff": lib_err,
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes": n_bytes, "ops": n_ops}
        tm = res["flash"][key]
        log(f"flash_attention BH={bh} S={s} D={d} bf16 causal: "
            f"kernel {tm['kernel_ms']:.4f} ms/launch (device "
            f"{device_ms:.4f}), plain {tm['plain_ms']:.4f} ms, SDPA "
            f"{tm['library_ms']:.4f} ms (max diff {lib_err:.3g}), bound "
            f"{tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']})")

    toks = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))).to(dev)
    prefill = lambda: lm.forward(params, {"tokens": toks}, cfg,
                                 prefill=True)
    res["prefill_ms"] = min(_time_ms(prefill, 1) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, cache = prefill()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(_device_us(e) for e in dev_events) / 1e3
    flash_busy = sum(_device_us(e) for e in dev_events
                     if _is_flash(e.key)) / 1e3
    res["prefill_device_ms"] = busy
    res["prefill_flash_device_ms"] = flash_busy
    res["prefill_flash_share"] = flash_busy / busy if busy else float("nan")
    res["prefill_top_device"] = [
        (e.key[:90], e.count, _device_us(e) / 1e3)
        for e in sorted(dev_events, key=_device_us, reverse=True)[:8]]

    cache = lm.pad_cache(cache, cfg, DECODE_TO)
    tok = toks[:, :1]
    pos = torch.full((PREFILL_BATCH,), PREFILL_LEN, device=dev)
    decode = lambda: lm.decode_step(params, cache, tok, pos, cfg)
    res["decode_step_ms"] = min(_time_ms(decode, 10) for _ in range(3))
    log(f"prefill {PREFILL_BATCH} x {PREFILL_LEN}: {res['prefill_ms']:.2f} "
        f"ms, device busy {busy:.2f} ms of which flash {flash_busy:.2f} ms "
        f"({res['prefill_flash_share']:.3f}); decode step at batch "
        f"{PREFILL_BATCH} against {DECODE_TO} slots: "
        f"{res['decode_step_ms']:.3f} ms")

    prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, 4 + u % 4)]
               for u in range(8)]

    def serve() -> tuple[float, int]:
        eng = engine_lib.BatchedEngine(cfg, params, batch_slots=4,
                                       s_max=128, device=dev)
        for uid, prompt in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=uid, prompt=prompt,
                                          max_new_tokens=12))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(max_rounds=256)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sum(len(r.generated) for r in done)

    serve()
    walls = [serve() for _ in range(2)]
    wall, n_tok = min(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = serve()
    busy = _device_busy_ms(prof)
    res["engine"] = {"tokens": n_tok, "wall_s": wall,
                     "wall_s_all": [w for w, _ in walls],
                     "tokens_per_s": n_tok / wall,
                     "wall_s_profiled": wall_prof, "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / (1e3 * wall)}
    log(f"BatchedEngine (8 requests, 4 slots, 12 new tokens): {n_tok} "
        f"tokens in {1e3 * wall:.1f} ms, {n_tok / wall:.1f} tokens/s, "
        f"device busy {busy:.2f} ms (idle share "
        f"{res['engine']['device_idle_share']:.3f}); LM timing "
        f"{time.perf_counter() - t_phase:.1f} s")
    return res


def _record(name, replaces, launches, cmp, timing,
            library_ms=None) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": cmp["max_abs_err"], "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": library_ms,
            "mismatches": cmp["mismatches"]}


def _tmac_extra(st: dict) -> dict:
    """#5's record beyond the common keys: 67 % events, the stack chain's
    layer 2, and ``torch._int_mm``'s time at the step shape."""
    out = {"int_mm_ms": st["int_mm_ms"],
           "int_mm_device_ms": st["int_mm_device_ms"]}
    for key, name in (("dense", "ternary_mac_dense"),
                      ("layer2", "ternary_mac_layer2")):
        for field in ("kernel_ms", "device_ms", "plain_ms", "bound_ms",
                      "library_ms", "library_device_ms"):
            label = "ms" if field == "kernel_ms" else field
            out[f"{label}_{key}"] = st[name][field]
    return out


def _large_extra(st: dict, name: str) -> dict:
    """#6's and #8's records beyond the common keys: ``LARGE_SHAPE`` (#6
    at the model's 5-bit codebook, ``_6bit`` at 6 bits, ``_unsorted`` with
    the linear count, at the step shape too), and the card's per-launch
    floor."""
    out = {"floor_device_ms": st["floor"]["device_ms"],
           "floor_event_ms": st["floor"]["event_ms"]}
    suffixes = (("unsorted", "large", "large_6bit", "large_unsorted",
                 "large_6bit_unsorted") if name == "nlq_lut" else ("large",))
    for suffix in suffixes:
        tm = st[f"{name}_{suffix}"]
        for field in ("kernel_ms", "device_ms", "plain_ms", "bound_ms",
                      "library_ms"):
            label = "ms" if field == "kernel_ms" else field
            out[f"{label}_{suffix}"] = tm[field]
    return out


def main() -> None:
    t0 = time.perf_counter()
    kind, smi = device_phase()
    dev = torch.device("cuda")
    build_s, flash_build, split_build, stage_build = build_phase()
    cmp = {"kwn": compare_phase(dev), "nld": compare_nld_phase(dev),
           "stack": compare_stack_phase(dev),
           "train": compare_train_phase(dev),
           "stage": compare_stage_phase(dev),
           "flash": compare_flash_phase(dev)}
    log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
    params, main_res = main_path_phase(dev)
    nld_params, nld_res = nld_path_phase(dev)
    _, stack_res = stack_path_phase(dev)
    train_params, train_res = train_path_phase(dev)
    composed_res = composed_path_phase(dev)
    lm_params, lm_res = lm_path_phase(dev)
    lm_res["faults"] = lm_fault_phase(dev)
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    timing = {"kwn": timing_phase(dev), "nld": nld_timing_phase(dev),
              "stack": stack_timing_phase(dev),
              "train": train_timing_phase(train_params, dev),
              "stage": stage_timing_phase(dev),
              "lm": lm_timing_phase(lm_params, dev)}
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
        log(f"[{smi}] {name}: {tm['kernel_ms']:.4f} ms/{unit} (device "
            f"{tm['device_ms']:.4f}), plain {tm['plain_ms']:.3f} ms/{unit}, "
            f"bound {tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']})")
    tt = timing["train"]
    for pol, tm in tt["bwd"].items():
        log(f"[{smi}] fused_macro_seq_kwn_bwd ({pol}): "
            f"{tm['kernel_ms']:.4f} ms/launch, plain {tm['plain_ms']:.3f} "
            f"ms, bound {tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']}); "
            f"contraction alone in torch.matmul {tt['library_ms']:.4f} ms")
    st = timing["stage"]
    for name in STAGE_KERNELS:
        tm = st[name]
        lib = ("none" if tm["library_ms"] is None
               else f"{tm['library_ms']:.4f} ms")
        log(f"[{smi}] {name}: {tm['kernel_ms']:.4f} ms/launch (device "
            f"{tm['device_ms']:.4f}), plain "
            f"{tm['plain_ms']:.4f} ms, library {lib}, bound "
            f"{tm['bound_ms'] * 1e3:.4f} us ({tm['bound_by']})")
    for name, label in (("ternary_mac_dense", "67 % events"),
                        ("ternary_mac_layer2", "stack chain layer 2, K=128")):
        tm = st[name]
        log(f"[{smi}] ternary_mac ({label}): {tm['kernel_ms']:.4f} ms/launch"
            f" (device {tm['device_ms']:.4f}), plain {tm['plain_ms']:.4f} "
            f"ms, torch.matmul {tm['library_ms']:.4f} ms (device "
            f"{tm['library_device_ms']:.4f}), bound "
            f"{tm['bound_ms'] * 1e3:.4f} us ({tm['bound_by']})")
    log(f"[{smi}] ternary_mac through its wrapper "
        f"{st['ternary_mac']['kernel_ms']:.4f} ms (device "
        f"{st['ternary_mac']['device_ms']:.4f}) against torch.matmul "
        f"{st['ternary_mac']['library_ms']:.4f} ms (device "
        f"{st['ternary_mac']['library_device_ms']:.4f}) and torch._int_mm "
        f"{st['int_mm_ms']:.4f} ms (device {st['int_mm_device_ms']:.4f}) "
        f"at the same shape")
    log(f"[{smi}] launch floor (zero_ of one element): device "
        f"{st['floor']['device_ms']:.4f} ms, CUDA events "
        f"{st['floor']['event_ms']:.4f} ms")
    for name in ("nlq_lut", "nlq_lut_unsorted", "lif_step"):
        tm = st[name]
        log(f"[{smi}] {name} at M={TRAIN_BATCH} N={CFG.n_hidden}: device "
            f"{tm['device_ms']:.4f} ms, bound {tm['bound_ms'] * 1e3:.4f} us,"
            f" {tm['bound_share']:.4f} of it")
    for case in (k for k in st if "_large" in k):
        tm = st[case]
        log(f"[{smi}] {case} at M={LARGE_SHAPE[0]} N={LARGE_SHAPE[1]}: "
            f"{tm['kernel_ms']:.4f} ms/launch (device {tm['device_ms']:.4f})"
            f", bound {tm['bound_ms'] * 1e3:.2f} us ({tm['bound_by']}), "
            f"{tm['bound_share']:.3f} of it on the device")
    log(f"[{smi}] chain step {st['chain_step_ms']:.4f} ms (device "
        f"{st['chain_step_device_ms']:.4f}), fused step "
        f"{st['fused_step_ms']:.4f} ms (device "
        f"{st['fused_step_device_ms']:.4f}); composed forward "
        f"{st['composed_forward_ms']:.2f} ms, seq "
        f"{st['seq_forward_ms']:.3f} ms")
    lt = timing["lm"]
    for shape, tm in lt["flash"].items():
        log(f"[{smi}] flash_attention (BH x S x D) {shape} bf16 causal: "
            f"{tm['kernel_ms']:.4f} ms/launch (device {tm['device_ms']:.4f}"
            f"), plain {tm['plain_ms']:.4f} ms, SDPA {tm['library_ms']:.4f} "
            f"ms, bound {tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']})")
    log(f"[{smi}] {LM_ARCH} prefill {PREFILL_BATCH} x {PREFILL_LEN}: "
        f"{lt['prefill_ms']:.2f} ms (flash {lt['prefill_flash_share']:.3f} "
        f"of device time); decode step {lt['decode_step_ms']:.3f} ms; "
        f"BatchedEngine {lt['engine']['tokens_per_s']:.1f} tokens/s, idle "
        f"share {lt['engine']['device_idle_share']:.3f}")
    log(f"[{smi}] silicon training step, DVS-Gesture batch "
        f"{TRAIN_BATCH}: {tt['step_ms']:.3f} ms, {tt['steps_per_s']:.1f} "
        f"steps/s, device idle share {tt['device_idle_share']:.3f}; "
        f"seq-KWN forward with trace {tt['fwd_ms']['trace']:.4f} ms "
        f"(without {tt['fwd_ms']['no_trace']:.4f} ms); kernels #1 and #3 "
        f"{tt['seq_kwn_device_share']:.3f} of the step's device time")
    path = "src/repro/kernels/fused_macro.py"
    kwn_launches = (main_res["clean"]["launches"]
                    + main_res["noisy"]["launches"]
                    + train_res["forward_launches"]
                    + sum(train_res["step_path_launches"].values()))
    record = {"kernels": [
        dict(_record("fused_macro_seq_kwn", f"{path}:524", kwn_launches,
                     cmp["kwn"], timing["kwn"]),
             device_ms=timing["kwn"]["device_ms"],
             ms_train=tt["fwd_ms"]["trace"],
             device_ms_train=tt["fwd_ms"]["device_trace"],
             plain_ms_train=tt["fwd_ms"]["plain_trace"],
             bound_ms_train=tt["fwd_ms"]["bound_ms"]),
        dict(_record("fused_macro_seq_nld", f"{path}:583",
                     nld_res["clean"]["launches"]
                     + nld_res["noisy"]["launches"],
                     cmp["nld"], timing["nld"]),
             device_ms=timing["nld"]["device_ms"]),
        dict(_record("fused_macro_multi_seq_kwn", f"{path}:896",
                     stack_res["clean"]["launches"]
                     + stack_res["noisy"]["launches"],
                     cmp["stack"], timing["stack"]),
             device_ms=timing["stack"]["device_ms"]),
        dict(_record("fused_macro_seq_kwn_bwd",
                     "src/repro/kernels/fused_macro_grad.py:73",
                     train_res["backward_launches"], cmp["train"]["bwd"],
                     tt["bwd"]["residual"], library_ms=tt["library_ms"]),
             device_ms=tt["bwd"]["residual"]["device_ms"],
             ms_remat=tt["bwd"]["remat"]["kernel_ms"],
             device_ms_remat=tt["bwd"]["remat"]["device_ms"],
             plain_ms_remat=tt["bwd"]["remat"]["plain_ms"],
             bound_ms_remat=tt["bwd"]["remat"]["bound_ms"])]
        + [dict(_record(name, f"src/repro/kernels/{src}.py:{line}",
                        composed_res["chain"]["launches"][name]
                        + composed_res["stack_chain"]["launches"][name],
                        cmp["stage"][name], st[name],
                        library_ms=st[name]["library_ms"]),
                device_ms=st[name]["device_ms"],
                library_device_ms=st[name]["library_device_ms"],
                **(_tmac_extra(st) if name == "ternary_mac" else {}),
                **(_large_extra(st, name) if name in ("nlq_lut", "lif_step")
                   else {}))
           for name, src, line in (("ternary_mac", "ternary_mac", 30),
                                   ("nlq_lut", "nlq_lut", 22),
                                   ("kwn_topk", "kwn_topk", 26),
                                   ("lif_step", "lif_step", 21))]
        + [dict(_record("flash_attention",
                        "src/repro/kernels/flash_attention.py:29",
                        lm_res["prefill"]["launches"]
                        + sum(c["launches"] for c in
                              lm_res["consistency"].values()),
                        cmp["flash"], lt["flash"][FLASH_MAIN],
                        library_ms=lt["flash"][FLASH_MAIN]["library_ms"]),
                device_ms=lt["flash"][FLASH_MAIN]["device_ms"],
                max_abs_err_bf16=cmp["flash"]["max_abs_err_bf16"])]}
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "build_s": build_s, "flash_build": flash_build,
         "split_build": split_build, "stage_build": stage_build,
         "compare": cmp,
         "main_path": {"kwn": main_res, "nld": nld_res, "stack": stack_res,
                       "train": train_res, "composed": composed_res,
                       "lm": lm_res},
         "timing": timing, "serving": serving, "nld_serving": nld_serving,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
