"""Fig. 7: measured NL-IMA statistics.
(a) NLQ transfer error: paper mu=0.41 LSB, sigma=1.34 LSB.
(b) NL-activation (y=0.5x^2) INL: paper 0.91 LSB.

Fig. 7a is measured on the counter noise stream that the fused kernels
draw in-kernel (seed 0), so its codes are a pure function of (seed, step,
row, column) and equal on the card and the CPU.  Fig. 7b's Monte-Carlo
noise comes from a ``torch.Generator`` seeded 0 on the device.  The JAX
script draws both from a key: the same law, other draws."""

import torch

from experiments_torch import _snn_cache as C
from repro_torch.core import ima


def run() -> dict:
    dev = C.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    nlq = ima.nlq_codebook(5, -64, 64).to(dev)
    transfer = ima.measure_transfer_error_ctr(nlq, seed=0)
    act = ima.activation_codebook(5, ima.quadratic, -8, 8).to(dev)
    inl_model = ima.measure_inl(act, ima.quadratic, generator=gen,
                                noise=ima.IMANoiseModel())
    inl_ideal = ima.measure_inl(act, ima.quadratic)
    return {
        "nlq_mean_lsb": round(transfer["mean_lsb"], 3),      # paper 0.41
        "nlq_sigma_lsb": round(transfer["std_lsb"], 3),      # paper 1.34
        "nl_activation_inl_lsb": round(inl_model, 3),        # paper 0.91
        "nl_activation_inl_ideal_emulation_lsb": round(inl_ideal, 3),
        "paper": {"mu": 0.41, "sigma": 1.34, "inl": 0.91},
    }
