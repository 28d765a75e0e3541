"""Silicon-in-the-loop SNN training: differentiate through the fused macro.

Counterpart of ``repro.train.silicon``.  The training forward is the
serving forward (the seq-KWN kernel, clean or with the Fig. 7 counter
noise, activity-gated) with its membrane trace; the backward is the
surrogate backward kernel, joined by the ``torch.autograd.Function``
``kernels.ops.fused_macro_seq_vjp`` (through ``core.macro.fused_seq_vjp``).

Every value is exact: spikes, masks and membranes equal the serving
kernel's bit for bit.  Only the gradient is a surrogate: SuperSpike through
the spike comparator, straight through inside the IMA ramp's window and
through the clipped twin-cell rounding, a relaxed straight-through gate at
the KWN winner mask (``kwn_relax`` leaks a share of the loser gradient),
and a hard cut at the V_mem rails.  Its reference is
``kernels.ref.fused_macro_seq_vjp_ref``.

With an ``ima.IMANoiseModel`` the forward trains against the in-kernel
Fig. 7 draws (noise-aware QAT); ``models.snn.train`` draws a fresh counter
seed for every step (``step_seed``), so every step sees a fresh silicon
instance.  Single-layer KWN only, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core import f32math
from repro_torch.core import lif as lif_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import prbs as prbs_lib
from repro_torch.core import ternary as ternary_lib

# Loser-gradient leak through the hard KWN winner gate: 0 is the pure hard
# gate (only winners learn), the reference's default keeps every column
# trainable while the value stays exactly top-K.
DEFAULT_KWN_RELAX = 0.1


def quantized_weight_ste(w_hid: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The integer-unit weight with a clipped straight-through gradient,
    and its per-column scale.

    Value: exactly ``quantize_weights_3bit(w_hid)[0]`` (the grid values
    the packers store).  Gradient: ``clip_mask / scale``, the straight
    through of ``ternary.quantize_weights_ste`` in integer MAC units, so
    that it composes with the kernel's integer-unit ``dW``.  Returns
    (w (I, N), scale (N,)), the scale without gradient.
    """
    w_int, scale2 = ternary_lib.quantize_weights_3bit(w_hid)
    scale2 = scale2.detach()                              # (1, N)
    w_sur = f32math.div(w_hid, scale2)
    clip_mask = (w_sur.detach().abs() <= 3.5).to(w_hid.dtype)
    w = w_int.detach() + (w_sur - w_sur.detach()) * clip_mask
    return w, scale2.reshape(-1)


def forward_logits(p: dict, events: torch.Tensor, cfg, seed: int, *,
                   noise=None, kwn_relax: float = DEFAULT_KWN_RELAX,
                   remat: bool = False) -> torch.Tensor:
    """Differentiable silicon forward on ``events``' device: events
    (B, T, N_in) -> logits (B, classes).

    The spike stacks equal ``snn.forward_silicon(p, ..., seed=seed)`` bit
    for bit; gradients reach ``w_hid`` (through the surrogate chain) and
    ``w_out`` (through the spike-count readout).  ``noise`` is the Fig. 7
    ``IMANoiseModel`` (noise-aware QAT), ``seed`` the counter seed word.
    KWN single layer only.
    """
    if cfg.mode != "kwn":
        raise ValueError(
            f"silicon-in-the-loop training supports mode='kwn' only "
            f"(got {cfg.mode!r}); NLD trains on the software STE path")
    if isinstance(p["w_hid"], (list, tuple)):
        raise NotImplementedError(
            "silicon-in-the-loop training is single-layer only; train "
            "stacks on the software path (forward_train)")
    dev = events.device
    b, t_steps = events.shape[0], events.shape[1]
    w, scale = quantized_weight_ste(p["w_hid"])
    mcfg = macro_lib.CIMMacroConfig(code_bits=cfg.code_bits,
                                    mac_range=cfg.mac_range,
                                    ima_noise=noise)
    lif_p = lif_lib.LIFParams(beta=cfg.beta, v_th1=cfg.v_th1,
                              v_th2=cfg.v_th2,
                              noise_amp=cfg.noise_amp if cfg.use_snl else 0.0)
    noisy = noise is not None
    ev_t = events.transpose(0, 1)                         # (T, B, N_in)
    v0 = lif_lib.lif_init((b, cfg.n_hidden), device=dev).v_mem
    noise_t = None                     # in-kernel counter SNL (or none)
    if not noisy and cfg.use_snl:
        noise_t = prbs_lib.sequence_noise(b, t_steps, cfg.n_hidden,
                                          lif_p.noise_amp, dev)
    spk_t, _ = macro_lib.fused_seq_vjp(
        ev_t, w, scale, mcfg, v0, k=cfg.k, drive_gain=cfg.drive_gain,
        beta=cfg.beta, v_th1=cfg.v_th1, v_th2=cfg.v_th2,
        v_reset=lif_p.v_reset, v_lim=lif_lib.vmem_limit(lif_p.vmem_bits),
        use_snl=cfg.use_snl, noise=noise_t,
        snl_amp=lif_p.noise_amp if noisy else 0.0, kwn_relax=kwn_relax,
        remat=remat, seed=int(seed))
    counts = spk_t.sum(0)
    # the actual sequence length, as the inference paths normalize
    return f32math.div(counts, t_steps) @ p["w_out"]


def loss_fn(p: dict, events: torch.Tensor, labels: torch.Tensor, cfg,
            seed: int, *, noise=None, kwn_relax: float = DEFAULT_KWN_RELAX,
            remat: bool = False) -> torch.Tensor:
    """Cross-entropy over the differentiable silicon forward."""
    logits = forward_logits(p, events, cfg, seed, noise=noise,
                            kwn_relax=kwn_relax, remat=remat)
    lse = torch.log_softmax(logits, dim=-1)
    return -lse.gather(1, labels[:, None].long()).mean()


def step_seed(generator: torch.Generator) -> int:
    """A fresh counter seed for one optimization step, in [0, 2^23)."""
    return int(torch.randint(0, 2 ** 23, (), generator=generator,
                             device=generator.device))
