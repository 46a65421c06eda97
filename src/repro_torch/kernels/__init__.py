"""Hand-written CUDA kernels (Hopper, sm_90a) for the serving hot spots.

- flash_attention: causal prefill attention with GQA, sliding window,
  logit softcap and per-row valid_from; online softmax over key tiles.
- decode_attention: one token against a (linear or ring) KV cache.
- int8_matmul: weight-only int8 x float matmul with per-output-channel
  scales applied after the fp32 sum.
- queue_scan: the scan engine's open-loop queue recurrence.
- cluster_scan: the scan cluster engine's request-axis scan.

Sources are in `csrc/`, built by `_build` with nvcc at first use. Each
kernel has a wrapper module with a launch counter, its plain PyTorch
version in `ref.py`, and a model-layout entry point in `ops.py`.
"""
