"""Finding model, per-line suppressions, and the checked-in baseline.

A finding is identified for baseline purposes by ``(rule, path, symbol,
message)`` — line numbers are deliberately excluded so unrelated edits
above a grandfathered finding do not invalidate the baseline. Messages
are therefore written to be deterministic (no memory addresses, no
ordering artifacts).

Suppressions are per-line comments::

    x = do_risky_thing()  # analysis: allow-broad-except — why it is ok

The marker may sit on the finding's own line or the line directly above
(for statements too long to carry a trailing comment). ``# noqa: BLE001``
is honored as an alias for ``allow-broad-except`` — the repo already
uses it to annotate intentional never-die loops.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"

_ALLOW_RE = re.compile(r"#\s*analysis:\s*((?:allow-[a-z0-9-]+(?:\([^)]*\))?[,\s]*)+)")
# one marker token: slug + optional parenthesized scope args. A marker
# WITH args is *scoped* — it does not blanket-suppress the rule on the
# line; the owning rule reads the args (scoped_marker_args) and decides
# per-item (cachesound's allow-cache-key(<inputs>) declares which cache
# inputs are deliberately excluded from the key, not "ignore this site").
_ALLOW_TOKEN_RE = re.compile(r"allow-([a-z0-9-]+)(?:\(([^)]*)\))?")
_NOQA_BLE_RE = re.compile(r"#\s*noqa:.*\bBLE001\b")

#: repo-native comment conventions accepted as rule suppressions, beyond
#: the canonical ``# analysis: allow-<rule>`` marker
_ALIAS_PATTERNS: Dict[str, re.Pattern] = {
    "broad-except": _NOQA_BLE_RE,
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int  # 1-based
    symbol: str  # enclosing Class.method / function ('' = module level)
    message: str
    severity: str = SEV_ERROR

    @property
    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{sym}"

    def to_dict(self) -> dict:
        return asdict(self)


def allowed_rules_for_line(lines: Sequence[str], line: int) -> set:
    """Rule slugs suppressed at 1-based ``line`` (its own trailing comment
    or a marker-only line directly above)."""
    out: set = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(lines):
            text = lines[ln - 1]
            m = _ALLOW_RE.search(text)
            if m:
                for tok, args in _ALLOW_TOKEN_RE.findall(m.group(1)):
                    if not args:  # scoped markers don't blanket-suppress
                        out.add(tok)
            for rule, pat in _ALIAS_PATTERNS.items():
                if pat.search(text):
                    out.add(rule)
    return out


def scoped_marker_args(
    lines: Sequence[str], line: int, rule: str
) -> Optional[List[str]]:
    """Args of a scoped ``# analysis: allow-<rule>(a, b, ...)`` marker at
    1-based ``line`` (own line or the line above), or None when the line
    carries no scoped marker for ``rule``. Args are comma/space-separated
    identifiers-or-paths; everything after `` — `` in an arg is a free-
    text reason and is dropped."""
    found: Optional[List[str]] = None
    for ln in (line, line - 1):
        if not (1 <= ln <= len(lines)):
            continue
        m = _ALLOW_RE.search(lines[ln - 1])
        if not m:
            continue
        for tok, args in _ALLOW_TOKEN_RE.findall(m.group(1)):
            if tok != rule or not args:
                continue
            out = []
            for part in re.split(r"[,\s]+", args.strip()):
                if part:
                    out.append(part)
            found = (found or []) + out
    return found


def is_suppressed(finding: Finding, lines: Sequence[str]) -> bool:
    return finding.rule in allowed_rules_for_line(lines, finding.line)


# ---------------------------------------------------------------------------
# baseline


@dataclass
class Baseline:
    """Grandfathered findings: present in the repo, acknowledged, not yet
    fixed. The gate fails on anything NOT in here; stale entries (no
    longer matching any finding) also fail so the file can only shrink
    honestly."""

    entries: List[dict] = field(default_factory=list)

    def keys(self) -> set:
        return {
            (e["rule"], e["path"], e.get("symbol", ""), e["message"])
            for e in self.entries
        }

    @staticmethod
    def load(path: str) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            return Baseline([])
        return Baseline(list(data.get("findings", [])))

    @staticmethod
    def from_findings(findings: Sequence[Finding], justification: str = "") -> "Baseline":
        entries = []
        for f in sorted(findings, key=lambda x: (x.path, x.line, x.rule)):
            e = {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
            }
            if justification:
                e["justification"] = justification
            entries.append(e)
        return Baseline(entries)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"findings": self.entries}, f, indent=2, sort_keys=False)
            f.write("\n")


def split_by_baseline(
    findings: Sequence[Finding], baseline: Optional[Baseline]
) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """→ (active, baselined, stale_baseline_entries)."""
    if baseline is None:
        return list(findings), [], []
    keys = baseline.keys()
    active = [f for f in findings if f.baseline_key not in keys]
    matched = {f.baseline_key for f in findings if f.baseline_key in keys}
    baselined = [f for f in findings if f.baseline_key in keys]
    stale = [
        e
        for e in baseline.entries
        if (e["rule"], e["path"], e.get("symbol", ""), e["message"]) not in matched
    ]
    return active, baselined, stale
