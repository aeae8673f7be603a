"""The mmt4d kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.mmt4d.ops import *  # noqa: F401,F403
