"""Structured results of the shard-safety checks.

Every check returns a list of :class:`Finding` — one per violated
invariant, never a bare string or an exception — so callers can
aggregate across programs and models, filter by severity, render a
human report (:func:`format_findings`) or machine-readable records
(:meth:`Finding.to_dict`), and gate CI on the result.  A clean program
is the empty list.
"""
from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import List

__all__ = ["Finding", "ERROR", "WARNING", "format_findings"]

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One violated invariant, located as precisely as the trace allows.

    Attributes
    ----------
    check : str
        Check id (e.g. ``"comm-scaling"``, ``"replication"``) — the
        registry key in :data:`multigrad_tpu_torch.analysis.checks.PROGRAM_CHECKS`.
    severity : str
        ``"error"`` (wrong answers or broken scaling claims) or
        ``"warning"`` (performance/hygiene hazards).
    message : str
        Human-readable statement of what is wrong and why it matters.
    program : str
        Label of the analyzed program (e.g. ``"SMFModel:loss_and_grad"``).
    where : str
        Source location of the offending equation (``file:line (fn)``),
        empty when the trace carries no user frame.
    path : str
        The op's position in the program (e.g. the aten op behind a
        finding).  Kept for the record's shape; the port's traces are
        flat, so it is mostly empty.
    """

    check: str
    severity: str
    message: str
    program: str = ""
    where: str = ""
    path: str = field(default="")

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        ctx = f" ({self.path})" if self.path else ""
        prog = f"{self.program}: " if self.program else ""
        return (f"{self.severity.upper()} {self.check}: "
                f"{prog}{self.message}{loc}{ctx}")


def format_findings(findings: List[Finding]) -> str:
    """Render findings as a numbered, severity-sorted report."""
    if not findings:
        return "clean: no findings"
    order = {ERROR: 0, WARNING: 1}
    ranked = sorted(findings,
                    key=lambda f: (order.get(f.severity, 2), f.check))
    lines = [f"{i + 1}. {f}" for i, f in enumerate(ranked)]
    n_err = sum(1 for f in findings if f.severity == ERROR)
    lines.append(f"-- {len(findings)} finding(s), {n_err} error(s)")
    return "\n".join(lines)
