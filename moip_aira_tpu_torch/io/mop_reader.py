"""Reader for multi-objective MPS (".mop") files.

Reference parity: src/problem.cpp:158-344 (`read_mop_problem`).  The reference
lets CPLEX read the MPS file and then re-parses it by hand: the *leading* 'N'
rows of the ROWS section are the objectives, in order (problem.cpp:205-217 —
the loop breaks at the first non-N row), and the COLUMNS section supplies the
per-objective coefficients.  The MPS objective sense is the shared sense of
all objectives (MPS default: minimise; the OBJSENSE extension is honoured).

Integer variables are declared through 'MARKER' INTORG/INTEND lines.  In line
with the bundled example (which gives every integer an explicit LO 0 / PL
bound pair) unbounded integer columns default to [0, +inf).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense


def read_mop(filename: str) -> Problem:
    with open(filename, "r") as fh:
        lines = fh.read().splitlines()

    section = None
    objsen = Sense.MIN
    obj_names: List[str] = []
    obj_index: Dict[str, int] = {}
    row_names: List[str] = []  # structural rows
    row_index: Dict[str, int] = {}
    row_sense: List[str] = []
    seen_non_n = False
    var_index: Dict[str, int] = {}
    var_names: List[str] = []
    is_int_list: List[bool] = []
    in_integer_block = False
    # sparse storage
    col_entries: List[tuple] = []  # (row_or_obj_key, var, value)
    rhs_entries: Dict[str, float] = {}
    range_entries: Dict[str, float] = {}
    bound_entries: List[tuple] = []  # (type, var, value or None)

    pending_objsense = False
    for raw in lines:
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        if is_header:
            head = raw.split()[0].upper()
            if head in ("NAME",):
                section = None
            elif head == "OBJSENSE":
                section = "objsense"
                pending_objsense = True
                rest = raw.split()[1:]
                if rest:
                    objsen = Sense.MAX if rest[0].upper().startswith("MAX") else Sense.MIN
                    pending_objsense = False
            elif head == "ROWS":
                section = "rows"
            elif head == "COLUMNS":
                section = "columns"
            elif head == "RHS":
                section = "rhs"
            elif head == "RANGES":
                section = "ranges"
            elif head == "BOUNDS":
                section = "bounds"
            elif head == "ENDATA":
                break
            else:
                section = None
            continue

        toks = raw.split()
        if section == "objsense" and pending_objsense:
            objsen = Sense.MAX if toks[0].upper().startswith("MAX") else Sense.MIN
            pending_objsense = False
        elif section == "rows":
            sense_ch = toks[0].upper()
            name = toks[1]
            if sense_ch == "N" and not seen_non_n:
                # Leading N rows are objectives (problem.cpp:205-217).
                obj_index[name] = len(obj_names)
                obj_names.append(name)
            elif sense_ch == "N":
                # A non-leading free row: the reference skips it entirely.
                continue
            else:
                seen_non_n = True
                row_index[name] = len(row_names)
                row_names.append(name)
                row_sense.append(sense_ch)
        elif section == "columns":
            if len(toks) >= 3 and toks[1] == "'MARKER'":
                if toks[2] == "'INTORG'":
                    in_integer_block = True
                elif toks[2] == "'INTEND'":
                    in_integer_block = False
                continue
            var = toks[0]
            if var not in var_index:
                var_index[var] = len(var_names)
                var_names.append(var)
                is_int_list.append(in_integer_block)
            # one or two (row, value) pairs per line
            for k in range(1, len(toks) - 1, 2):
                col_entries.append((toks[k], var, float(toks[k + 1])))
        elif section == "rhs":
            for k in range(1, len(toks) - 1, 2):
                rhs_entries[toks[k]] = float(toks[k + 1])
        elif section == "ranges":
            for k in range(1, len(toks) - 1, 2):
                range_entries[toks[k]] = float(toks[k + 1])
        elif section == "bounds":
            btype = toks[0].upper()
            var = toks[2]
            val = float(toks[3]) if len(toks) > 3 else None
            bound_entries.append((btype, var, val))

    objcnt = len(obj_names)
    if objcnt == 0:
        raise ValueError(f"{filename}: no leading N rows (objectives) found")
    n = len(var_names)
    m_struct = len(row_names)

    C = np.zeros((objcnt, n))
    A = np.zeros((m_struct, n))
    for row, var, val in col_entries:
        vi = var_index[var]
        if row in obj_index:
            C[obj_index[row], vi] = val
        elif row in row_index:
            A[row_index[row], vi] = val
        # else: reference silently skips unknown rows (problem.cpp:272-274)

    row_lb = np.full(m_struct, -INF)
    row_ub = np.full(m_struct, INF)
    for i, (name, s) in enumerate(zip(row_names, row_sense)):
        b = rhs_entries.get(name, 0.0)
        if s == "L":
            row_ub[i] = b
        elif s == "G":
            row_lb[i] = b
        elif s == "E":
            row_lb[i] = row_ub[i] = b
        if name in range_entries:
            r = range_entries[name]
            if s == "L":
                row_lb[i] = b - abs(r)
            elif s == "G":
                row_ub[i] = b + abs(r)
            elif s == "E":
                if r >= 0:
                    row_ub[i] = b + r
                else:
                    row_lb[i] = b + r

    lb = np.zeros(n)
    ub = np.full(n, INF)
    is_int = np.array(is_int_list, dtype=bool)
    for btype, var, val in bound_entries:
        if var not in var_index:
            continue
        i = var_index[var]
        if btype == "LO":
            lb[i] = val
        elif btype == "UP":
            ub[i] = val
            if val is not None and val < 0 and lb[i] == 0.0:
                lb[i] = -INF  # classic MPS quirk
        elif btype == "FX":
            lb[i] = ub[i] = val
        elif btype == "FR":
            lb[i], ub[i] = -INF, INF
        elif btype == "MI":
            lb[i] = -INF
        elif btype == "PL":
            ub[i] = INF
        elif btype == "BV":
            lb[i], ub[i] = 0.0, 1.0
            is_int[i] = True
        elif btype in ("LI", "UI"):
            if btype == "LI":
                lb[i] = val
            else:
                ub[i] = val
            is_int[i] = True

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
