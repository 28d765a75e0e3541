"""Event-stream datasets (counterpart of ``repro.data``)."""
