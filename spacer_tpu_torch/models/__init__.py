"""Model families ported to PyTorch (Qwen2.5-VL)."""
