"""A small Prometheus text-exposition-format checker: the port's copy of
``karpenter_core_tpu/metrics/textcheck.py``. Tests and ``chip_smoke.py``
use it to fail fast on metric-surface regressions (HELP/TYPE pairing,
label escaping, histogram bucket monotonicity).

This is deliberately a *checker*, not a parser-for-use: it validates the
subset of the format Registry.expose() emits (text format 0.0.4, no
exemplars/OM extensions) and returns human-readable problem strings.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# sample line: name{labels} value [timestamp]
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$"
)

_VALID_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}


def _parse_labels(raw: str) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """Parse a label body (the text between { and }) → (labels, error).
    Hand-rolled scanner so unescaped quotes/backslashes are *detected*
    rather than silently accepted."""
    labels: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        eq = raw.find("=", i)
        if eq < 0:
            return None, f"missing '=' in label body at offset {i}"
        name = raw[i:eq]
        if not _LABEL_NAME_RE.match(name):
            return None, f"bad label name {name!r}"
        if eq + 1 >= n or raw[eq + 1] != '"':
            return None, f"label {name!r} value not quoted"
        j = eq + 2
        value_chars: List[str] = []
        while j < n:
            c = raw[j]
            if c == "\\":
                if j + 1 >= n:
                    return None, f"label {name!r} has trailing backslash"
                esc = raw[j + 1]
                if esc not in ('"', "\\", "n"):
                    return None, f"label {name!r} has invalid escape \\{esc}"
                value_chars.append("\n" if esc == "n" else esc)
                j += 2
                continue
            if c == '"':
                break
            if c == "\n":
                return None, f"label {name!r} value contains raw newline"
            value_chars.append(c)
            j += 1
        else:
            return None, f"label {name!r} value unterminated"
        if name in labels:
            return None, f"duplicate label name {name!r}"
        labels[name] = "".join(value_chars)
        i = j + 1
        if i < n:
            if raw[i] != ",":
                return None, f"expected ',' after label {name!r}"
            i += 1
    return labels, None


def _family_of(sample_name: str, typed: Dict[str, str]) -> Optional[str]:
    """Map a sample name to its declared family, honoring histogram /
    summary suffixes."""
    if sample_name in typed:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if typed.get(base) in ("histogram", "summary"):
                return base
    return None


def check_exposition(text: str) -> List[str]:
    """Validate a /metrics payload; returns a list of problems (empty ⇒
    well-formed). Checks:

    - HELP/TYPE lines are well-formed, at most one of each per family,
      and TYPE precedes that family's samples
    - every sample belongs to a declared family (histogram suffixes
      resolved), names/labels are legal, label values legally escaped
    - sample values parse as floats ("+Inf"/"-Inf"/"NaN" allowed)
    - no duplicate (name, labels) series
    - per histogram series: ``le`` buckets are cumulative-monotone in
      ascending ``le`` order, the +Inf bucket exists and equals _count
    """
    problems: List[str] = []
    typed: Dict[str, str] = {}
    helped: Dict[str, bool] = {}
    seen_sample_of: Dict[str, bool] = {}
    series_seen: set = set()
    # histogram family → series key → list of (le, count); counts keyed
    # off the non-le label set
    buckets: Dict[str, Dict[tuple, List[Tuple[float, float]]]] = {}
    counts: Dict[str, Dict[tuple, float]] = {}

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                if parts[1:2] and parts[1] in ("HELP", "TYPE"):
                    problems.append(f"line {ln}: malformed {parts[1]} line")
                continue  # arbitrary comments are legal
            kind, name = parts[1], parts[2]
            if not _NAME_RE.match(name):
                problems.append(f"line {ln}: bad metric name {name!r} in {kind}")
                continue
            if kind == "HELP":
                if helped.get(name):
                    problems.append(f"line {ln}: duplicate HELP for {name}")
                helped[name] = True
            else:
                t = parts[3].strip() if len(parts) > 3 else ""
                if t not in _VALID_TYPES:
                    problems.append(f"line {ln}: invalid TYPE {t!r} for {name}")
                if name in typed:
                    problems.append(f"line {ln}: duplicate TYPE for {name}")
                if seen_sample_of.get(name):
                    problems.append(
                        f"line {ln}: TYPE for {name} appears after its samples"
                    )
                typed[name] = t
            continue

        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {ln}: unparseable sample line {line!r}")
            continue
        name = m.group("name")
        family = _family_of(name, typed)
        if family is None:
            problems.append(f"line {ln}: sample {name} has no preceding TYPE")
            family = name
        seen_sample_of[family] = True
        if not helped.get(family):
            problems.append(f"line {ln}: sample {name} has no HELP for {family}")
            helped[family] = True  # report once per family
        labels: Dict[str, str] = {}
        if m.group("labels") is not None:
            labels, err = _parse_labels(m.group("labels"))
            if err is not None:
                problems.append(f"line {ln}: {err}")
                continue
        raw_value = m.group("value")
        try:
            value = float(raw_value)
        except ValueError:
            problems.append(f"line {ln}: unparseable value {raw_value!r}")
            continue
        series = (name, tuple(sorted(labels.items())))
        if series in series_seen:
            problems.append(f"line {ln}: duplicate series {name}{dict(labels)}")
        series_seen.add(series)

        if typed.get(family) == "histogram":
            base_labels = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            if name == family + "_bucket":
                le_raw = labels.get("le")
                if le_raw is None:
                    problems.append(f"line {ln}: bucket sample without le label")
                    continue
                try:
                    le = float(le_raw)
                except ValueError:
                    problems.append(f"line {ln}: unparseable le {le_raw!r}")
                    continue
                buckets.setdefault(family, {}).setdefault(base_labels, []).append(
                    (le, value)
                )
            elif name == family + "_count":
                counts.setdefault(family, {})[base_labels] = value

    for family, by_series in buckets.items():
        for base_labels, pairs in by_series.items():
            pairs.sort(key=lambda p: p[0])
            label_str = dict(base_labels) or ""
            last = -math.inf
            for le, count in pairs:
                if count < last:
                    problems.append(
                        f"{family}{label_str}: bucket le={le} count {count} < "
                        f"previous bucket's {last} (not cumulative)"
                    )
                last = count
            if not pairs or not math.isinf(pairs[-1][0]):
                problems.append(f"{family}{label_str}: missing +Inf bucket")
            else:
                total = counts.get(family, {}).get(base_labels)
                if total is not None and pairs[-1][1] != total:
                    problems.append(
                        f"{family}{label_str}: +Inf bucket {pairs[-1][1]} != "
                        f"_count {total}"
                    )
    return problems
