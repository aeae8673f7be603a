"""The selective_scan kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.selective_scan.ops import *  # noqa: F401,F403
