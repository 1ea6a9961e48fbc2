"""CSV tables with the ``csv`` module, read and written as the JAX package's
CLIs read and write them with pandas (the card's machine has no pandas).

- ``read_table``: a CSV's header and rows of strings.
- ``cell_text``: a string cell as ``str()`` of pandas' value gives it: the
  cells pandas reads as missing (``NA_TOKENS``, an empty cell among them)
  become ``"nan"``.
- ``write_table``: rows of strings under a header, ``\\n``-terminated and
  minimally quoted as ``DataFrame.to_csv``; ``as_written`` gives what
  pandas writes back for a cell it read (a missing one: empty).
- ``read_predictions``: a prediction CSV (``fname`` plus one float column a
  class) as (fnames, class columns in file order, (N, C) float64);
  ``read_prediction_files`` concatenates several, columns in one order.
"""

from __future__ import annotations

import csv
from typing import List, Optional, Sequence, Tuple

import numpy as np

# pandas.read_csv's default missing-value strings (STR_NA_VALUES)
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV file, every cell a string."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row]
    for row in rows:
        if len(row) != len(header):
            raise ValueError(f"{path}: a row of {len(row)} cells under a "
                             f"header of {len(header)}")
    return header, rows


def cell_text(cell: str) -> str:
    """``str()`` of the value pandas reads from ``cell``."""
    return "nan" if cell in NA_TOKENS else cell


def as_written(cell: str) -> str:
    """What ``to_csv`` writes for the value pandas read from ``cell``."""
    return "" if cell in NA_TOKENS else cell


def write_table(path: str, header: Sequence[str], rows) -> None:
    """Rows of strings under ``header``, each cell as given."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def read_predictions(path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """(fnames, class columns in file order, (N, C) float64 values)."""
    header, rows = read_table(path)
    if "fname" not in header:
        raise ValueError(f"{path}: no column 'fname'")
    fnames = [row[header.index("fname")] for row in rows]
    classes = [c for c in header if c != "fname"]
    idx = [header.index(c) for c in classes]
    values = np.array([[float(row[k]) for k in idx] for row in rows],
                      dtype=np.float64).reshape(len(rows), len(classes))
    return fnames, classes, values


def read_prediction_files(paths: Sequence[str],
                          classes: Optional[Sequence[str]] = None) -> tuple:
    """(fnames, classes, (N, C) float64) of the prediction CSVs ``paths``
    concatenated in order, their columns in the order of ``classes``
    (default: the first file's, sorted); a missing column raises."""
    fnames, values = [], []
    for path in paths:
        f, cols, v = read_predictions(path)
        if classes is None:
            classes = sorted(cols)
        missing = [c for c in classes if c not in cols]
        if missing:
            raise ValueError(f"{path}: no class columns {missing}")
        fnames += f
        values.append(v[:, [cols.index(c) for c in classes]])
    return fnames, list(classes), np.concatenate(values)
