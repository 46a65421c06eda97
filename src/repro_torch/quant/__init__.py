"""Quantization: int8 per-output-channel weights for the serving fast
path (the paper's 8-bit post-training quantization study, Fig 6), and
int8 with error feedback for DiLoCo's outer sync."""

from repro_torch.quant.int8 import (dequantize_int8, dequantize_tree,
                                    ef_compress, quantize_exec_tree,
                                    quantize_int8, quantize_tree,
                                    tree_bytes_quantized)

__all__ = ["quantize_int8", "dequantize_int8", "quantize_tree",
           "dequantize_tree", "ef_compress", "quantize_exec_tree",
           "tree_bytes_quantized"]
