"""PyTorch / CUDA port of the NeuDW-CIM reproduction (Hopper, sm_90a).

The package mirrors ``repro``'s layout module for module (``core/``,
``kernels/``, ``models/``, ``serve/``, ``obs/``) and imports neither JAX
nor anything of ``repro``: the JAX package is the reference it is held
against in the tests, never a dependency.

Entry points (``models.snn.forward_silicon``, ``forward_silicon_stream``,
``serve.engine.SNNEventEngine``, ``kernels.ops.fused_macro_seq``) run on
``cuda`` unless the caller passes ``device="cpu"``.  On a CUDA tensor a
kernel wrapper launches its hand-written kernel (``csrc/``) or raises; the
plain PyTorch version beside each kernel runs only for CPU tensors.
"""
