"""PyTorch model definitions (NCHW modules, torch-reference parameter names)."""
