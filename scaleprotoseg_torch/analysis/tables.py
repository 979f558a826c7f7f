"""The analysis CLIs' tables without pandas (the GPU machine has none).

What the JAX package's analysis writes through pandas, reproduced on rows
of Python values: ``write_csv`` is ``DataFrame(rows, columns=...)
.to_csv(index=False)`` (a column holding a float or NaN is written as
floats, ``repr`` digits and NaN as an empty field, an all-integer column
as integers), ``group_mean`` the ``groupby(keys)[cols].agg(np.nanmean)
.reset_index()`` of the consistency metric, ``inner_merge`` ``merge(on=
keys)``, an inner join in the left rows' order.
"""

from __future__ import annotations

import csv
import math
import numbers
from typing import Dict, List, Sequence

import numpy as np


def _is_float(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(
        v, (numbers.Integral, bool, np.bool_))


def _cell(v, as_float: bool) -> str:
    if isinstance(v, str):
        return v
    if as_float:
        f = float(v)
        return "" if math.isnan(f) else repr(f)
    return str(int(v))


def write_csv(path: str, columns: Sequence[str],
              rows: Sequence[Sequence]) -> None:
    """``pd.DataFrame(rows, columns=columns).to_csv(path, index=False)``."""
    floats = [any(_is_float(r[j]) for r in rows)
              for j in range(len(columns))]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(v, fl) for v, fl in zip(r, floats)])


def records(columns: Sequence[str], rows: Sequence[Sequence]
            ) -> List[Dict]:
    return [dict(zip(columns, r)) for r in rows]


def group_mean(rows: List[Dict], keys: Sequence[str],
               cols: Sequence[str]) -> List[Dict]:
    """One row a distinct ``keys`` tuple, in sorted key order, with the
    NaN-ignoring mean of each of ``cols`` (NaN where all are NaN)."""
    groups: Dict[tuple, List[Dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    out = []
    for key in sorted(groups):
        vals = np.array([[r[c] for c in cols] for r in groups[key]],
                        dtype=np.float64)
        n = (~np.isnan(vals)).sum(axis=0)
        s = np.nansum(vals, axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(n > 0, s / np.maximum(n, 1), np.nan)
        out.append({**dict(zip(keys, key)),
                    **{c: float(m) for c, m in zip(cols, mean)}})
    return out


def inner_merge(left: List[Dict], right: List[Dict],
                keys: Sequence[str]) -> List[Dict]:
    """Rows of ``left`` joined with every ``right`` row of the same keys,
    in ``left``'s order, then ``right``'s."""
    index: Dict[tuple, List[Dict]] = {}
    for r in right:
        index.setdefault(tuple(r[k] for k in keys), []).append(r)
    out = []
    for r in left:
        for s in index.get(tuple(r[k] for k in keys), ()):
            out.append({**r, **{k: v for k, v in s.items() if k not in keys}})
    return out


def column_mean(values: Sequence[float]) -> float:
    """A column's mean, 0.0 when it is empty (as the JAX scripts write
    an empty table's score)."""
    return float(np.mean(np.asarray(values, np.float64))) if len(values) \
        else 0.0
