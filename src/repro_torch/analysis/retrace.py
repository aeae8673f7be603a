"""The recompile-hazard detector.

``Engine.warmup`` makes every step program (on the card, captures every
graph), and the standing contract is that nothing is made afterwards.
The model's ``trace_log`` records each program's argument signature
(``{"kind", "args": name -> (shape, dtype) or None}``, written by
:class:`repro_torch.models.model.CompiledStep` and the compiled train
step); :class:`RetraceDetector` diffs every entry after ``mark()``
against the closest earlier one of the same kind and names the argument
whose shape or dtype changed.  PyTorch has no ``weak_type``: its
counterpart hazard is a dtype leak, such as an int64 position where
warmup saw int32, or a width off the ladder.
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Finding

__all__ = ["RetraceDetector", "diff_signatures"]

_PASS = "retrace"


def diff_signatures(before: dict, after: dict) -> List[str]:
    """Readable per-argument diffs between two signatures' ``args``."""
    out = []
    for key in sorted(set(before) | set(after)):
        b, a = before.get(key), after.get(key)
        if b == a:
            continue
        if b is None:
            out.append(f"{key}: absent -> {a}")
        elif a is None:
            out.append(f"{key}: {b} -> absent")
        else:
            parts = [f"{field} {bv!r} -> {av!r}" for field, bv, av
                     in zip(("shape", "dtype"), b, a) if bv != av]
            out.append(f"{key}: " + ", ".join(parts))
    return out


class RetraceDetector:
    """Watch a model's compiled steps for programs made after warmup::

        det = RetraceDetector(model)
        engine.warmup()
        det.mark()                  # everything made so far is legitimate
        ... traffic ...
        findings = det.findings()   # [] unless a program was made
    """

    def __init__(self, model):
        self.model = model
        self._mark = len(model.trace_log)

    def mark(self) -> None:
        self._mark = len(self.model.trace_log)

    def retraces(self) -> List[dict]:
        return self.model.trace_log[self._mark:]

    def findings(self, label: str = "model") -> List[Finding]:
        log = self.model.trace_log
        out: List[Finding] = []
        for i in range(self._mark, len(log)):
            entry = log[i]
            prior = [e for e in log[:i] if e["kind"] == entry["kind"]]
            where = f"{label} compiled_step({entry['kind']!r})"
            if not prior:
                out.append(Finding(
                    _PASS, "unwarmed-kind", where,
                    f"the first program of kind {entry['kind']!r} was made "
                    f"after warmup: this step family was never warmed"))
                continue
            # the closest prior signature (fewest differing arguments) is
            # the program this call just missed
            best = min((diff_signatures(p["args"], entry["args"])
                        for p in prior), key=len)
            out.append(Finding(
                _PASS, "post-warmup-trace", where,
                f"a program was made after warmup; the closest warmed "
                f"signature differs in {len(best)} argument(s): "
                + "; ".join(best[:4]) + ("; ..." if len(best) > 4 else ""),
                detail={"kind": entry["kind"], "diff": best}))
        return out
