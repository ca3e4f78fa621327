"""RNG-lineage checking: the correlated-streams bug class the reference
once shipped, machine-checked (the twin of ``repro.analysis.rng``).

Two layers:

* ``rng_report`` — a lineage checker over one eager call.  Every generator
  made through ``_util.stream_generator``/``_util.position_generator``
  while the call runs is recorded with its effective seed (the splitmix64
  of (seed, tag, counters…)) and its call site.  Two call sites that get
  the same effective seed are flagged (``reused-key``: two consumers, one
  stream), as is one call site that gets the same effective seed more than
  once (``loop-reuse``: a generator re-seeded identically on each trip of a
  loop redraws the same numbers).  The reference value-numbers PRNG keys
  through a jaxpr; the port's draws come from seeded generators, so the
  seed is the key.  The hook records and draws nothing, so no drawn bit
  changes.

* ``sweep_fold_in_sites`` — a source-level (AST) sweep of ``src/repro_torch``.
  No ``torch.Generator(`` or ``manual_seed(`` may appear outside
  ``_util.py``, and every ``stream_generator``/``position_generator`` call
  must pass a registered tag (``repro_torch.analysis.streams``) by name, by
  value or as ``TAG + i``, or carry a ``# rng-stream: <name>`` marker on
  its line or the line above.  The reference's name is kept: the port's
  ``fold_in`` is the tag and counter folding of those two functions.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from repro_torch.analysis import streams as streams_mod


@dataclasses.dataclass
class RngIssue:
    """One lineage violation found in a recorded call."""

    kind: str            # "reused-key" | "loop-reuse"
    key: str             # the effective seed, in hex
    sites: list[str]     # the consuming call sites (path:line)
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.detail}"


@dataclasses.dataclass
class RngReport:
    """Every generator made during the call plus the violations derived
    from them: ``consumptions`` generators over ``keys_seen`` distinct
    effective seeds."""

    issues: list = dataclasses.field(default_factory=list)
    consumptions: int = 0
    keys_seen: int = 0

    @property
    def ok(self) -> bool:
        """True when no lineage violation was found."""
        return not self.issues


def report_from_events(events: list[tuple[int, str]]) -> RngReport:
    """The lineage report of recorded (effective seed, call site) events."""
    by_seed: dict[int, list[str]] = {}
    for seed, site in events:
        by_seed.setdefault(seed, []).append(site)
    issues = []
    for seed, sites in by_seed.items():
        distinct = sorted(set(sites))
        if len(distinct) >= 2:
            issues.append(RngIssue(
                "reused-key", hex(seed), distinct,
                f"seed {hex(seed)} drawn from by {len(distinct)} independent call sites "
                f"({distinct}) without a distinguishing tag or counter"))
        for site in distinct:
            if sites.count(site) >= 2:
                issues.append(RngIssue(
                    "loop-reuse", hex(seed), [site],
                    f"seed {hex(seed)} made {sites.count(site)} times at {site}: every "
                    "trip redraws the same numbers (fold the loop counter in)"))
    return RngReport(issues=issues, consumptions=len(events), keys_seen=len(by_seed))


def rng_report(fn, *args, **kwargs) -> RngReport:
    """Run ``fn(*args, **kwargs)`` once, recording every generator it makes
    through ``_util``, and check the lineage."""
    return record(fn, *args, **kwargs)[1]


def record(fn, *args, **kwargs):
    """(fn's result, its ``RngReport``)."""
    from repro_torch import _util

    events: list = []

    def hook(seed, site):
        events.append((seed, site))

    _util.RNG_HOOKS.append(hook)
    try:
        out = fn(*args, **kwargs)
    finally:
        _util.RNG_HOOKS.remove(hook)
    return out, report_from_events(events)


# --------------------------------------------------------------------------- #
# source-level sweep
# --------------------------------------------------------------------------- #

_MARKER = re.compile(r"#\s*rng-stream:\s*([\w\-]+)")
_MAKERS = ("stream_generator", "position_generator")
_RAW = ("Generator", "manual_seed")
_UTIL = "_util.py"   # defines the two makers, and alone may seed a generator

SRC_ROOT = pathlib.Path(__file__).resolve().parents[1]   # src/repro_torch


@dataclasses.dataclass
class FoldInSite:
    """One generator-making call site found by the AST sweep."""

    path: str            # relative to the swept root
    lineno: int
    source: str          # the call's first source line, stripped
    stream: str | None   # registered stream satisfied here (None = violation)
    via: str             # "tag" | "marker" | "raw" | "unregistered"

    @property
    def ok(self) -> bool:
        """True when the site carries a registered stream tag or marker."""
        return self.stream is not None


def _tag_stream_name(node: ast.expr) -> str | None:
    """Stream name if ``node`` is a registered inline tag expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        s = streams_mod.stream_for_tag(node.value)
        return s.name if s else None
    ident = node.id if isinstance(node, ast.Name) else (
        node.attr if isinstance(node, ast.Attribute) else None)
    if ident is not None:
        return streams_mod.TAG_CONSTANT_TO_STREAM.get(ident)
    if isinstance(node, ast.BinOp):
        return _tag_stream_name(node.left) or _tag_stream_name(node.right)
    return None


def _callee(node: ast.Call) -> str | None:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)


def _tag_arg(node: ast.Call) -> ast.expr | None:
    if len(node.args) >= 2:
        return node.args[1]
    return next((k.value for k in node.keywords if k.arg == "tag"), None)


def sweep_fold_in_sites(root: pathlib.Path | str = SRC_ROOT) -> list[FoldInSite]:
    """Inventory every generator-making call under ``root`` (default
    src/repro_torch), ``_util.py`` (which defines the makers) aside:
    ``stream_generator``/``position_generator`` calls, and
    ``torch.Generator``/``manual_seed`` calls (always violations,
    ``via="raw"``)."""
    root = pathlib.Path(root)
    sites: list[FoldInSite] = []
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root))
        if rel == _UTIL:
            continue
        text = path.read_text()
        lines = text.splitlines()
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _callee(node)
            if name in _RAW:
                stream, via = None, "raw"
            elif name in _MAKERS:
                tag = _tag_arg(node)
                stream = None if tag is None else _tag_stream_name(tag)
                via = "tag" if stream else "unregistered"
                if stream is None:
                    lo = max(node.lineno - 2, 0)
                    hi = min(getattr(node, "end_lineno", node.lineno), len(lines))
                    for ln in lines[lo:hi]:
                        m = _MARKER.search(ln)
                        if m and m.group(1) in streams_mod.REGISTRY:
                            stream, via = m.group(1), "marker"
                            break
            else:
                continue
            sites.append(FoldInSite(path=rel, lineno=node.lineno,
                                    source=lines[node.lineno - 1].strip(),
                                    stream=stream, via=via))
    return sites


def check_fold_in_sites(root: pathlib.Path | str = SRC_ROOT) -> list[FoldInSite]:
    """The violations: unregistered generator sites under ``root``."""
    return [s for s in sweep_fold_in_sites(root) if not s.ok]
