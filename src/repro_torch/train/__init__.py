"""Training through the fused macro (counterpart of ``repro.train``)."""
