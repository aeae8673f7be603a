"""The findings every check of :mod:`repro_torch.analysis` reports."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["Finding", "AnalysisReport"]


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


class AnalysisReport:
    """An ordered collection of findings across checks and configurations;
    ``sections`` names everything analyzed, green or not."""

    def __init__(self):
        self.findings: List[Finding] = []
        self.sections: List[str] = []

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, findings, section: Optional[str] = None) -> None:
        self.findings.extend(findings)
        if section is not None:
            self.sections.append(section)

    def format(self) -> str:
        lines = [f"analyzed: {', '.join(self.sections) or '(nothing)'}"]
        if self.ok:
            lines.append("OK: no findings")
        else:
            lines.append(f"{len(self.findings)} finding(s):")
            lines += ["  " + f.format() for f in self.findings]
        return "\n".join(lines)
