"""Network modules of the port (channel-last activations, reference
checkpoint parameter names)."""
