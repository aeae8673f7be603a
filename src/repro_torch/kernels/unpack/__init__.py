"""The unpack kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.unpack.ops import *  # noqa: F401,F403
