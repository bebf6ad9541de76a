"""The few device calls the drivers make, which a CPU rehearsal of a driver
(the tests) turns into no-ops."""
from __future__ import annotations


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_reserved(device) -> int:
    """The most memory the process's allocator has held on the device since
    the last `reset_peak`: graph pools, staging, activations."""
    import torch

    return torch.cuda.max_memory_reserved() if torch.device(device).type == "cuda" else 0


def release(device) -> None:
    """Collect what the program left and hand its cached blocks back."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
