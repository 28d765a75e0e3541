"""Models served through the fused macro kernel."""
