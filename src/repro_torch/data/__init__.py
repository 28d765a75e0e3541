"""Event-stream datasets and the synthetic LM stream (counterpart of
``repro.data``)."""
