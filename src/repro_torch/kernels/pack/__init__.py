"""The pack kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.pack.ops import *  # noqa: F401,F403
