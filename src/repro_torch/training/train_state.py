"""Train state: the step, the parameters and the optimizer state."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: dict

    @classmethod
    def create(cls, params, optimizer) -> "TrainState":
        return cls(step=0, params=params, opt_state=optimizer.init(params))
