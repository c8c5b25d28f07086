"""Aggregate comparison CSVs into a CSV table and a LaTeX table.

The port's copy of ``experiments/comparisons_to_table.py`` (schema parity
with the reference's generator, ``experiments/python/comparisons_to_table.py:9-143``):
per experiment the mean / std / median over repetitions, milliseconds
converted to seconds, a booktabs LaTeX table.  It reads the CSVs of either
package's harness and writes ``{label}_{tau}_table.csv`` (the columns the
JAX package's generator writes when no xlsx writer is installed) and
``../latex/comparisons_{label}_{tau}.tex``.  Plain Python and numpy: no
pandas, no tabulate.
"""

import csv
import math
from pathlib import Path

import numpy as np


def _read(path):
    """CSV rows as dicts, numbers as floats (an empty field is NaN)."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    for row in rows:
        for k, v in row.items():
            if k != "experiment":
                try:
                    row[k] = float(v) if v != "" else math.nan
                except ValueError:
                    pass
    return rows


def _by_experiment(rows):
    """experiment -> its rows, experiments sorted."""
    out = {}
    for row in rows:
        out.setdefault(row["experiment"], []).append(row)
    return dict(sorted(out.items()))


def _std(v):
    """Sample standard deviation (NaN for fewer than two values)."""
    return float(np.std(v, ddof=1)) if len(v) > 1 else math.nan


def _fmt(x, fmt="{:.2f}"):
    return fmt.format(x)


def save_to_table(out_dir, tau, label, latex=True, sig21=True, sig06=False,
                  amg=False, direct=False, cg=False, std=False,
                  names_counts=True):
    """The comparison table as a list of dicts, one per experiment, sorted by
    vertex count; times in seconds."""
    hier = _by_experiment(_read(f"{out_dir}/hierarchy_ours_{label}.csv"))
    ours = _by_experiment(_read(f"{out_dir}/solver_ours_tau{tau}_{label}.csv"))
    extra = {}       # column -> experiment -> value (one row per experiment)

    def single(path, columns, rename=None):
        for exp, rows in _by_experiment(_read(path)).items():
            for c in columns:
                extra.setdefault((rename or {}).get(c, c), {})[exp] = rows[0][c]

    if direct:
        single(f"{out_dir}/direct_tau{tau}_{label}.csv",
               ("direct_factor", "direct_solve", "pardiso_factor", "pardiso_solve"))
    if sig21:
        single(f"{out_dir}/hierarchy_sig21_{label}.csv", ("sig21_hierarchy",))
        single(f"{out_dir}/solver_sig21_tau{tau}_{label}.csv",
               ("iterations", "solver_total", "residue"),
               {"iterations": "sig21_iterations", "residue": "sig21_residue",
                "solver_total": "sig21_solver"})
    if sig06:
        single(f"{out_dir}/hierarchy_sig06_{label}.csv", ("hierarchy",),
               {"hierarchy": "sig06_hierarchy"})
        single(f"{out_dir}/solver_sig06_tau{tau}_{label}.csv",
               ("iterations", "solver_total", "residue"),
               {"iterations": "sig06_iterations", "residue": "sig06_residue",
                "solver_total": "sig06_solver"})
    if amg:
        for tag in ("rs", "sa"):
            single(f"{out_dir}/amg_{tag}_tau{tau}_{label}.csv",
                   (f"{tag}_hierarchy", f"{tag}_iterations", f"{tag}_solver"))
    if cg:
        single(f"{out_dir}/cg_tau{tau}_{label}.csv", ("cg_solver",))

    seconds = {"direct_factor", "direct_solve", "pardiso_factor", "pardiso_solve",
               "sig21_hierarchy", "sig21_solver", "sig06_hierarchy", "sig06_solver"}
    table = []
    for exp, hrows in hier.items():
        h = [r["hierarchy"] for r in hrows]
        o = ours[exp]
        it = [r["iterations"] for r in o]
        res = [r["residue"] for r in o]
        tot = [r["solver_total"] for r in o]
        row = {
            "experiment": exp.replace("_", " ").title(),
            "n_vertices": f"{int(max(r['n_vertices'] for r in hrows) / 1000)}k",
            "_n": max(r["n_vertices"] for r in hrows),
            "mean_hierarchy": float(np.mean(h)) / 1000,
            "std_hierarchy": _std(h) / 1000,
            "median_iterations": int(np.median(it)),
            "mean_iterations": float(np.mean(it)),
            "std_iterations": _std(it),
            "mean_solver": float(np.mean(tot)) / 1000,
            "std_solver": _std(tot) / 1000,
            "mean_residue": float(np.mean(res)),
            "std_residue": _std(res),
        }
        for col, vals in extra.items():
            row[col] = vals[exp] / 1000 if col in seconds else vals[exp]
        row["our_hierarchy"] = _fmt(row["mean_hierarchy"])
        row["our_iterations"] = _fmt(row["mean_iterations"])
        row["our_solve"] = _fmt(row["mean_solver"])
        row["our_residue"] = _fmt(row["mean_residue"], "{:.2e}")
        if std:
            row["our_hierarchy"] += "(" + _fmt(row["std_hierarchy"]) + ")"
            row["our_solve"] += "(" + _fmt(row["std_solver"]) + ")"
        table.append(row)
    table.sort(key=lambda r: r.pop("_n"))

    columns = list(table[0]) if table else []
    with open(f"{out_dir}/{label}_{tau}_table.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(columns)
        for row in table:
            w.writerow(["" if isinstance(row[c], float) and math.isnan(row[c])
                        else row[c] for c in columns])

    if latex:
        cols, headers = [], []
        if names_counts:
            cols += ["experiment", "n_vertices"]
            headers += ["Model", "Vertices"]
        cols += ["our_hierarchy", "median_iterations", "our_solve"]
        headers += ["Hier. (s)", "#Iter.", "Solve (s)"]
        if sig21:
            cols += ["sig21_hierarchy", "sig21_iterations", "sig21_solver"]
            headers += ["SIG21 Hier. (s)", "#Iter.", "Solve (s)"]
        if sig06:
            cols += ["sig06_hierarchy", "sig06_iterations", "sig06_solver"]
            headers += ["SIG06 Hier. (s)", "#Iter.", "Solve (s)"]
        if amg:
            cols += ["rs_hierarchy", "rs_iterations", "rs_solver",
                     "sa_hierarchy", "sa_iterations", "sa_solver"]
            headers += ["RS Hier. (s)", "#Iter.", "Solve (s)",
                        "SA Hier. (s)", "#Iter.", "Solve (s)"]
        if direct:
            cols += ["direct_factor", "direct_solve", "pardiso_factor", "pardiso_solve"]
            headers += ["Fact. (s)", "Subst. (s)", "Par. Fact. (s)", "Par. Subst. (s)"]
        latex_dir = Path(out_dir).parents[0] / "latex"
        latex_dir.mkdir(parents=True, exist_ok=True)
        (latex_dir / f"comparisons_{label}_{tau}.tex").write_text(
            _booktabs(headers, [[row[c] for c in cols] for row in table]))
    return table


def _booktabs(headers, rows):
    """A booktabs LaTeX tabular: text left-aligned, numbers right-aligned
    with two decimals (integers as they are)."""
    def cell(v):
        if isinstance(v, (int, np.integer)):
            return str(v)
        if isinstance(v, float):
            return _fmt(v)
        return str(v)

    def numeric(v):
        if isinstance(v, (int, float, np.integer)):
            return True
        try:
            float(v)
            return True
        except ValueError:
            return False

    align = "".join("r" if rows and all(numeric(r[i]) for r in rows) else "l"
                    for i in range(len(headers)))
    body = [" & ".join(headers) + r" \\", r"\midrule"]
    body += [" & ".join(cell(v) for v in r) + r" \\" for r in rows]
    return "\n".join([rf"\begin{{tabular}}{{{align}}}", r"\toprule", body[0],
                      *body[1:], r"\bottomrule", r"\end{tabular}"])
