"""Quantization: int8 per-output-channel weights for the serving fast
path (the paper's 8-bit post-training quantization study, Fig 6)."""

from repro_torch.quant.int8 import quantize_exec_tree, tree_bytes_quantized

__all__ = ["quantize_exec_tree", "tree_bytes_quantized"]
