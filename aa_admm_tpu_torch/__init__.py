"""aa_admm_tpu_torch — the PyTorch/CUDA port of aa_admm_tpu.

The JAX package ``aa_admm_tpu`` stays the reference; this package mirrors its
module layout (``core``, ``ops``, ``solver``, ``apps``) so each function has a
counterpart of the same name. It imports torch, numpy and scipy only — never
jax and nothing of ``aa_admm_tpu`` — and its three hand-written CUDA kernels
(``csrc/``, bound in ``ops/cuda_kernels.py``) replace the JAX package's Pallas
kernels.

Device: entry points take ``device=None``, meaning the CUDA card; without one
they raise unless the caller passes ``device="cpu"``. The tensors' device alone
decides between a kernel (CUDA) and its plain torch twin (CPU).
"""

import torch

# Counterpart of the JAX package's "highest" matmul precision: float32
# products stay true float32 (TF32 keeps ~3 decimal digits, which breaks the
# global-step solve and the closest-point candidate ranking).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (the default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aa_admm_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
