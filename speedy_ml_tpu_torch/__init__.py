"""PyTorch/CUDA port of speedy_ml_tpu for one NVIDIA H100.

The layout mirrors the JAX package (core/, esn/, hybrid/, physics/,
data/); kernels/ holds the hand-written CUDA kernels of the hot path with
their plain PyTorch versions.  Public functions keep the JAX layouts
(vals slot-major (J, R, n), Wout (R, O, S+n), fields (V, K, lat, lon)).

Entry points run on CUDA unless the caller passes device="cpu"; with no
CUDA device and none named they raise.  On a CPU tensor every kernel
wrapper runs its plain version; on a CUDA tensor it launches the kernel
or raises.

Precision policy (the reference's transform/semi-implicit findings): a
float32 matmul or convolution never drops to TF32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Raises when no device is named and no CUDA device is present: the
    port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")
