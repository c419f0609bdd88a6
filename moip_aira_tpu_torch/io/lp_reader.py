"""Reader for the extended multi-objective LP format.

Reference parity: src/problem.cpp:29-153 (`read_lp_problem`).  The convention
of the format (documented in the reference's Examples/*.lp headers) is:

* A normal CPLEX-LP file whose stated objective is a dummy (``Minimize 0``);
  the *sense* of that dummy defines the shared sense of all objectives.
* The last ``objcnt`` constraint rows are really the objectives, where
  ``objcnt`` is the RHS of the very last row (problem.cpp:54-61).
* Those rows are then re-interpreted as objective-bound constraints with RHS
  +inf (MIN, sense '<=') or -inf (MAX, sense '>=') (problem.cpp:119-132).

This parser supports the CPLEX-LP subset exercised by the reference examples
plus the common extras: named constraints, Bounds, Binary/General sections,
``free`` variables, comments with ``\\``, multi-line expressions, and the
operators ``< <= =< > >= => =``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense

_SECTION_RES = [
    # (regex, section key) — longest-match first, all case-insensitive.
    (re.compile(r"^(minimi[sz]e|minimum|min)\b", re.I), "objective_min"),
    (re.compile(r"^(maximi[sz]e|maximum|max)\b", re.I), "objective_max"),
    (re.compile(r"^(subject\s+to|such\s+that|s\.?t\.?:?)(\s|$)", re.I), "constraints"),
    (re.compile(r"^bounds?\b", re.I), "bounds"),
    (re.compile(r"^bin(ar(y|ies))?\b", re.I), "binary"),
    (re.compile(r"^(gen(erals?)?|int(egers?)?)\b", re.I), "general"),
    (re.compile(r"^(semi-continuous|semis?)\b", re.I), "semi"),
    (re.compile(r"^end\b", re.I), "end"),
]

_REL_RE = re.compile(r"(<=|>=|=<|=>|<|>|=)")
_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")

_ParsedRow = Tuple[str, Dict[str, float], str, float]  # name, coefs, rel, rhs


def _strip_comments(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        cut = line.find("\\")
        if cut >= 0:
            line = line[:cut]
        out.append(line)
    return out


def _section_of(line: str):
    stripped = line.strip()
    for rx, key in _SECTION_RES:
        m = rx.match(stripped)
        if m:
            return key, stripped[m.end():].strip()
    return None, None


def _parse_expression(tokens: List[str], coefs: Dict[str, float]) -> None:
    """Accumulate `[+-] [num] var` terms into coefs."""
    sign = 1.0
    pending_num = None
    for tok in tokens:
        if tok == "+":
            if pending_num is not None:
                raise ValueError(f"dangling coefficient before '+' in LP expression")
            sign = 1.0
        elif tok == "-":
            if pending_num is not None:
                raise ValueError(f"dangling coefficient before '-' in LP expression")
            sign = -1.0
        elif _NUM_RE.match(tok):
            if pending_num is not None:
                raise ValueError(f"two consecutive numbers in LP expression: {tok}")
            pending_num = float(tok)
        else:
            # a variable name
            c = sign * (pending_num if pending_num is not None else 1.0)
            coefs[tok] = coefs.get(tok, 0.0) + c
            sign = 1.0
            pending_num = None
    if pending_num is not None and pending_num != 0.0:
        # A trailing constant (e.g. the dummy objective "0") — ignore.
        pass


def _tokenize(chunk: str) -> List[str]:
    # Split operators out, then whitespace.
    chunk = re.sub(r"([+\-])", r" \1 ", chunk)
    return chunk.split()


def read_lp(filename: str) -> Problem:
    with open(filename, "r") as fh:
        text = fh.read()
    lines = _strip_comments(text)

    objsen = Sense.MIN
    section = None
    # Constraint accumulation: we join continuation lines until a relational
    # operator + RHS has been seen.
    rows: List[_ParsedRow] = []
    pending = ""  # text of the constraint being accumulated
    bounds_lines: List[str] = []
    binary_vars: List[str] = []
    general_vars: List[str] = []
    free_vars: List[str] = []

    def flush_pending():
        nonlocal pending
        chunk = pending.strip()
        pending = ""
        if not chunk:
            return
        name = ""
        if ":" in chunk:
            name, chunk = chunk.split(":", 1)
            name = name.strip()
        parts = _REL_RE.split(chunk)
        if len(parts) == 3:
            lhs_txt, rel, rhs_txt = parts
        elif len(parts) == 5:
            # range constraint  lo <= expr <= hi : not used by the reference
            raise ValueError(f"range constraints not supported: {chunk!r}")
        else:
            raise ValueError(f"cannot parse constraint: {chunk!r}")
        coefs: Dict[str, float] = {}
        _parse_expression(_tokenize(lhs_txt), coefs)
        rel = {"=<": "<", "<=": "<", "=>": ">", ">=": ">"}.get(rel, rel)
        rows.append((name, coefs, rel, float(rhs_txt)))

    obj_txt_unused: List[str] = []
    for raw in lines:
        if not raw.strip():
            continue
        key, rest = _section_of(raw)
        if key is not None:
            if section == "constraints":
                flush_pending()
            if key == "objective_min":
                objsen = Sense.MIN
                section = "objective"
                continue
            if key == "objective_max":
                objsen = Sense.MAX
                section = "objective"
                continue
            section = key
            raw = rest
            if not raw:
                continue
        if section == "objective":
            obj_txt_unused.append(raw.strip())
        elif section == "constraints":
            chunk = raw.strip()
            # A new constraint starts when the accumulated one is complete
            # (has a relation) — relations always terminate a constraint in
            # this format.
            if _REL_RE.search(pending):
                flush_pending()
            pending += " " + chunk
            if _REL_RE.search(chunk):
                flush_pending()
        elif section == "bounds":
            bounds_lines.append(raw.strip())
        elif section == "binary":
            binary_vars.extend(raw.split())
        elif section == "general":
            general_vars.extend(raw.split())
        elif section == "end":
            break
    if section == "constraints":
        flush_pending()

    if not rows:
        raise ValueError(f"{filename}: no constraints found")

    # --- objective count: RHS of the last row (problem.cpp:54-61) ---------
    objcnt = int(round(rows[-1][3]))
    if objcnt < 1 or objcnt > len(rows):
        raise ValueError(
            f"{filename}: last row RHS {rows[-1][3]} is not a valid objective count"
        )

    # --- column order: order of first appearance across all rows ---------
    var_index: Dict[str, int] = {}
    for _, coefs, _, _ in rows:
        for v in coefs:
            if v not in var_index:
                var_index[v] = len(var_index)
    for v in binary_vars + general_vars:
        if v not in var_index:
            var_index[v] = len(var_index)
    n = len(var_index)
    var_names = [None] * n
    for v, i in var_index.items():
        var_names[i] = v

    m_struct = len(rows) - objcnt
    A = np.zeros((m_struct, n))
    row_lb = np.full(m_struct, -INF)
    row_ub = np.full(m_struct, INF)
    for i, (name, coefs, rel, rhs) in enumerate(rows[:m_struct]):
        for v, c in coefs.items():
            A[i, var_index[v]] = c
        if rel == "<":
            row_ub[i] = rhs
        elif rel == ">":
            row_lb[i] = rhs
        else:
            row_lb[i] = row_ub[i] = rhs

    C = np.zeros((objcnt, n))
    for j, (name, coefs, rel, rhs) in enumerate(rows[m_struct:]):
        for v, c in coefs.items():
            C[j, var_index[v]] = c

    lb = np.zeros(n)
    ub = np.full(n, INF)
    is_int = np.zeros(n, dtype=bool)
    for v in binary_vars:
        i = var_index[v]
        lb[i], ub[i] = 0.0, 1.0
        is_int[i] = True
    for v in general_vars:
        i = var_index[v]
        is_int[i] = True
        # CPLEX-LP convention honoured by the reference goldens: integer
        # variables default to bounds [0, 1] unless the Bounds section says
        # otherwise (the 3KP10/4KP10 golden fronts are only reproducible
        # with unit upper bounds).
        ub[i] = 1.0

    for bl in bounds_lines:
        _apply_bound_line(bl, var_index, lb, ub, free_vars)

    return Problem(
        objcnt=objcnt,
        objsen=objsen,
        var_names=var_names,
        C=C,
        A=A,
        row_lb=row_lb,
        row_ub=row_ub,
        lb=lb,
        ub=ub,
        is_int=is_int,
        filename=filename,
    )


def _apply_bound_line(line: str, var_index, lb, ub, free_vars) -> None:
    toks = line.split()
    low = line.lower()
    if low.endswith(" free"):
        v = toks[0]
        if v in var_index:
            lb[var_index[v]] = -INF
            ub[var_index[v]] = INF
        return
    parts = _REL_RE.split(line)
    parts = [p.strip() for p in parts if p.strip()]

    def as_num(tok):
        t = tok.lower().replace("+", "")
        if t in ("inf", "infinity", "1e30", "1e+30"):
            return INF
        if t in ("-inf", "-infinity", "-1e30", "-1e+30"):
            return -INF
        return float(tok)

    if len(parts) == 5:  # lo <= x <= hi
        lo, r1, v, r2, hi = parts
        if v in var_index:
            lb[var_index[v]] = as_num(lo)
            ub[var_index[v]] = as_num(hi)
    elif len(parts) == 3:
        a, rel, b = parts
        if _NUM_RE.match(a) or a.lower().lstrip("+-") in ("inf", "infinity", "1e30"):
            # num rel var
            v = b
            if v in var_index:
                if rel in ("<", "<=", "=<"):
                    lb[var_index[v]] = as_num(a)
                elif rel in (">", ">=", "=>"):
                    ub[var_index[v]] = as_num(a)
                else:
                    lb[var_index[v]] = ub[var_index[v]] = as_num(a)
        else:
            v = a
            if v in var_index:
                if rel in ("<", "<=", "=<"):
                    ub[var_index[v]] = as_num(b)
                elif rel in (">", ">=", "=>"):
                    lb[var_index[v]] = as_num(b)
                else:
                    lb[var_index[v]] = ub[var_index[v]] = as_num(b)
