"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; with
no card and no explicit request they raise instead of drifting to the
CPU."""
import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; raise if that is asked for and absent."""
    if device is None:
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return device
