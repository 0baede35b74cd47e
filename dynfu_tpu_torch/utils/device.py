"""Device enumeration / info.

Port of dynfu_tpu/utils/device.py, the analog of the reference's CUDA
device management (kfusion::cuda::getCudaEnabledDeviceCount / setDevice /
printCudaDeviceInfo, include/kfusion/kinfu.hpp:23-31, src/kfusion/core.cpp:
8-211), over torch.cuda. The source's check_platform warns and carries on
when it finds only a CPU; here it raises unless the caller asked for the
CPU, so nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import torch


def device_count() -> int:
    return torch.cuda.device_count()


def devices():
    return [torch.device("cuda", i) for i in range(device_count())]


def print_short_device_info(index: int = 0) -> str:
    """One-line device summary (printShortCudaDeviceInfo analog)."""
    line = (f"Device {index}: {torch.cuda.get_device_name(index)} "
            f"({device_count()} device(s) visible)")
    print(line)
    return line


def print_device_info(index: int = 0) -> str:
    """Multi-line device report (printCudaDeviceInfo analog, core.cpp:40+):
    name, compute capability, total memory and memory in use."""
    prop = torch.cuda.get_device_properties(index)
    lines = [
        f"Device {index}: {prop.name}",
        f"  compute capability: {prop.major}.{prop.minor}",
        f"  multiprocessors:    {prop.multi_processor_count}",
        f"  total memory:       {prop.total_memory / 2**20:.0f} MiB",
        f"  memory in use:      "
        f"{torch.cuda.memory_allocated(index) / 2**20:.0f} MiB",
        f"  visible devices:    {device_count()}",
    ]
    out = "\n".join(lines)
    print(out)
    return out


def check_platform(device="cuda") -> torch.device:
    """The device to run on: a CUDA device when a card is usable; the CPU
    only when the caller asked for it. Raises otherwise (the source warns
    and carries on; the reference refuses pre-Fermi cards, core.cpp:31-38)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} is not usable: "
                           "torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()} (pass --cpu, or "
                           "device='cpu', to run on the CPU)")
    return device
