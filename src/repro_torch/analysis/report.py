"""The findings every check of :mod:`repro_torch.analysis` reports."""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Finding"]


@dataclasses.dataclass
class Finding:
    """One contract violation: the check (``pass_name``) and its rule,
    where it was found (an engine label), a message precise enough to act
    on, and optional evidence."""

    pass_name: str
    rule: str
    where: str
    message: str
    detail: Optional[dict] = None

    def format(self) -> str:
        s = f"[{self.pass_name}/{self.rule}] {self.where}: {self.message}"
        if self.detail:
            kv = ", ".join(f"{k}={v!r}" for k, v in sorted(self.detail.items()))
            s += f"  ({kv})"
        return s
