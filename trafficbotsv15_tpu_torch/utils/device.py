"""Device resolution for the port's entry points, and the copy of results to the host.

Entry points run on the CUDA device unless the caller asks for the CPU
explicitly; without a GPU and without that request they raise rather than
carry on on the CPU. The default card is the rank's own
(`parallel/mesh.py::local_device`: cuda:LOCAL_RANK under torchrun, cuda:0
without it), made the current device.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from trafficbotsv15_tpu_torch.parallel.mesh import local_device


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        device = "cuda"
        if torch.cuda.is_available():
            device = local_device()
            torch.cuda.set_device(device)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_host(x) -> np.ndarray:
    """A tensor (bf16 as float32) or array-like as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)
