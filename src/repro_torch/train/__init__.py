"""Training: the SNN's silicon path, and the LM's optimizer, steps,
checkpoints and gradient compression (counterpart of ``repro.train``)."""
