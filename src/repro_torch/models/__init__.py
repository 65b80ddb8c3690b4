"""Model layers, attention, the dense decoder stack and its registry."""
