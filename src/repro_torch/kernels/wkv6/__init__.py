"""The wkv6 kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.wkv6.ops import *  # noqa: F401,F403
