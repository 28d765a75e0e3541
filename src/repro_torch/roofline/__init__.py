"""Roofline terms on the H100 (counterpart of ``repro.roofline``)."""
