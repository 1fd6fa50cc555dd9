"""The card the run is on, and what the result line says of it."""

from __future__ import annotations

import subprocess


class NoCard(Exception):
    """The run asked for more cards than this machine has."""


def require(chips: int) -> None:
    """Raise NoCard unless torch sees a CUDA card, and at least ``chips``."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards; torch sees {torch.cuda.device_count()}")


def power_limit_w() -> float | None:
    """The card's power limit by nvidia-smi, in W (None if it says none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Card:
    """The device a run steps on. The harness's own tests drive a run on the
    CPU; there every device reading is left out, never read from the host."""

    def __init__(self, dev):
        self.dev = dev
        self.is_cuda = dev.type == "cuda"

    def sync(self) -> None:
        if self.is_cuda:
            import torch

            torch.cuda.synchronize(self.dev)

    def peak(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated(self.dev) if self.is_cuda else 0

    def reset_peak(self) -> None:
        if self.is_cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.dev)

    def empty_cache(self) -> None:
        if self.is_cuda:
            import torch

            torch.cuda.empty_cache()

    def describe(self, chips: int, memory_peak_bytes: int) -> dict:
        if not self.is_cuda:
            return {"platform": "cpu", "kind": "not measured", "count": 0}
        import torch

        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(self.dev),
            "count": chips,
            "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit_w": power_limit_w(),
        }
