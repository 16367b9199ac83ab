"""Scene, material and room models (PyTorch)."""
