"""The ragged_attn kernel: its wrapper and helpers (``ops``), re-exported."""

from repro_torch.kernels.ragged_attn.ops import *  # noqa: F401,F403
