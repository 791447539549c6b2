"""The process group's helpers, frozen from the port's `utils/`."""
