"""repro_torch: the CNNSelect serving system on PyTorch and CUDA.

The same system as the `repro` package (SLA-aware model selection in
front of a batched LM inference engine), with the model path written
in PyTorch and the attention and int8 kernels written by hand in CUDA
C++ for Hopper (`sm_90a`). Layout and names follow `repro`, so every
module has a counterpart there.

Entry points run on the card ("cuda") unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version. There is no fallback from the card to the CPU.
"""

import torch

# IEEE float32 products everywhere: the fp32 parity of this package
# against the reference is held at 2e-5, and TF32 keeps ~3 decimal
# digits. Matmul already defaults to full fp32; cuDNN does not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
