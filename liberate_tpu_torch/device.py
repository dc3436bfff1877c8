"""Where the port's tensors live when the caller does not say."""

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` unless the caller names another device. Without a CUDA
    device the caller must ask for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "PyTorch twins on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)
