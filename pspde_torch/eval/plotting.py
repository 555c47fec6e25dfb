"""Experiment logs (counterpart of ``pspde/eval/plotting.py:save_exp_logs``
and ``load_exp_logs``, utilities.py:475-484), through which the notebook
scripts save their runs.  The figures of that module are not ported (the
card's machine has no matplotlib)."""

from __future__ import annotations

import json
import os
from datetime import date

# the per-model logs saved beside the loss: the HJB solvers' u-L2 and IS
# logs, the stopped solvers' value errors and the eigen solver's lambda
_EXP_LOG_ATTRS = ("u_L2_loss", "IS_rel_log", "V_L2_log", "V_test_L2",
                  "V_test_abs", "V_test_rel_abs", "lambda_log")


def save_exp_logs(models, name, log_dir="logs") -> str:
    """JSON of each model's loss log and whichever of ``_EXP_LOG_ATTRS`` it
    holds, keyed by the model's name, to ``<log_dir>/<name>_<date>.json``;
    returns the path."""
    os.makedirs(log_dir, exist_ok=True)
    exp_log = {}
    for m in models:
        entry = {"loss": m.loss_log}
        for attr in _EXP_LOG_ATTRS:
            if getattr(m, attr, None):
                entry[attr] = getattr(m, attr)
        exp_log[m.name] = entry
    filename = "%s_%s.json" % (name, date.today().strftime("%Y-%m-%d"))
    with open(os.path.join(log_dir, filename), "w") as f:
        json.dump(exp_log, f)
    return os.path.join(log_dir, filename)


def load_exp_logs(filename, log_dir="logs") -> dict:
    with open(os.path.join(log_dir, filename)) as f:
        return json.load(f)


__all__ = ["load_exp_logs", "save_exp_logs"]
