"""Checkpoints of the port's four solvers (``pspde_torch/utils/
checkpoint.py``), CPU.

* tests/test_resume.py:43-63 on the port: a save at iteration k, a load
  into a fresh solver and training on give the uninterrupted run's logs,
  parameters, Adam state and generator states bitwise, for every solver,
  at one step a call and in chunks (resumed off a chunk boundary too).
* ``save_networks`` / ``load_networks`` and ``HJBSolver.save_logs`` round
  trips, and ``save_exp_logs`` / ``load_exp_logs``.
"""

import json

import numpy as np
import pytest
import torch

import pspde_torch.problems as tp
from pspde_torch.eval import load_exp_logs, save_exp_logs
from pspde_torch.solvers import (EigenSolver, EllipticSolver, GeneralSolver,
                                 HJBSolver)


def _hjb(L, **kw):
    return HJBSolver("h", tp.LLGC(d=3, T=0.5, device="cpu"), lr=1e-2, L=L,
                     K=64, delta_t=0.1, time_approx="inner",
                     loss_method="log-variance", learn_Y_0=True,
                     verbose=False, early_stopping_time=None, device="cpu",
                     **kw)


def _ell(L, **kw):
    return EllipticSolver(tp.ExponentialOnSphere(d=3, device="cpu"), "e",
                          L=L, K=64, K_boundary=16, N=6, delta_t=1e-2,
                          verbose=False, K_test_log=64, device="cpu", **kw)


def _gen(L, **kw):
    return GeneralSolver(tp.HeatEquation(d=3, device="cpu"), "g", L=L,
                         K=64, K_boundary=16, N=6, delta_t=1e-2,
                         verbose=False, device="cpu", **kw)


def _eig(L, **kw):
    return EigenSolver(tp.FokkerPlanckEigen(d=2, device="cpu"), "f", L=L,
                       K=64, K_boundary=16, N=5, verbose=False,
                       device="cpu", **kw)


MAKERS = {"hjb": _hjb, "elliptic": _ell, "general": _gen, "eigen": _eig}


def _state(s):
    """Logs, state tensors and generator states of a solver."""
    logs = {name: getattr(s, name) for name in s._LOG_ATTRS
            if name != "times"}
    tensors = {k: v.detach().clone() for k, v in s._state_tensors().items()}
    gens = {k: g.get_state() for k, g in s._chunk_generators().items()}
    gens["_seed_gen"] = s._seed_gen.get_state()
    return logs, tensors, gens


def _assert_same(a, b):
    la, ta, ga = _state(a)
    lb, tb, gb = _state(b)
    assert la == lb
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("spc", [1, 4])
@pytest.mark.parametrize("name", sorted(MAKERS))
def test_save_resume_matches_uninterrupted(tmp_path, name, spc):
    make = MAKERS[name]
    ref = make(16, steps_per_call=spc)
    ref.train()
    s = make(6, steps_per_call=spc)
    s.train()
    path = s.save_training_state(out_dir=str(tmp_path))
    s2 = make(16, steps_per_call=spc)
    s2.load_training_state(path)
    assert s2.iteration == 6 and len(s2.loss_log) == 6
    s2.train()
    assert len(s2.loss_log) == 16
    _assert_same(ref, s2)


def test_hjb_diagnostics_resume(tmp_path):
    """The diagnostics' generators and logs resume too."""
    def make(L):
        return HJBSolver("d", tp.LLGC(d=1, T=0.4, device="cpu"), L=L, K=32,
                         delta_t=0.1, time_approx="outer",
                         compute_gradient_variance=2, IS_variance_K=128,
                         IS_variance_iter=2, verbose=False,
                         early_stopping_time=None, device="cpu")

    ref = make(8)
    ref.train()
    s = make(3)
    s.train()
    path = s.save_training_state(out_dir=str(tmp_path))
    s2 = make(8)
    s2.load_training_state(path)
    s2.train()
    assert s2.grads_rel_error_log == ref.grads_rel_error_log
    assert s2.IS_rel_log == ref.IS_rel_log and len(ref.IS_rel_log) == 4
    _assert_same(ref, s2)
    with open(path + ".logs.json") as f:
        meta = json.load(f)
    assert meta["step"] == 3 and sorted(meta["logs"]) == sorted(
        HJBSolver._LOG_ATTRS)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_save_load_networks(tmp_path, name):
    """load_networks restores the modules and Adam's state of the saved
    solver into another one (its generators stay its own)."""
    make = MAKERS[name]
    a = make(5)
    a.train()
    path = a.save_networks(out_dir=str(tmp_path))
    b = make(5, seed=7)
    b.load_networks(path)
    ta, tb = a._state_tensors(), b._state_tensors()
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_save_logs_round_trip(tmp_path, monkeypatch):
    s = _hjb(4)
    s.train()
    p1 = s.save_logs(log_dir=str(tmp_path))
    p2 = s.save_logs(log_dir=str(tmp_path))
    assert p1 != p2 and p2.endswith("_2.json")
    with open(p1) as f:
        logs = json.load(f)
    assert {"name", "date", "d", "T", "seed", "delta_t", "N", "lr", "K",
            "loss_method", "learn_Y_0", "adaptive_forward_process",
            "Y_0_log", "loss_log", "u_L2_loss", "params"} == set(logs)
    assert logs["loss_log"] == s.loss_log and logs["N"] == s.N
    for name, val in s.z_net.state_dict().items():
        np.testing.assert_array_equal(
            np.asarray(logs["params"]["z_net"][name], dtype=np.float32),
            val.numpy())
    # save_results: train() saves the logs to ./logs, as pspde's
    monkeypatch.chdir(tmp_path)
    saved = _hjb(2, save_results=True)
    saved.train()
    assert len(list((tmp_path / "logs").iterdir())) == 1


def test_exp_logs_round_trip(tmp_path):
    """tests/test_eval_diagnostics.py:64-78's log part on the port."""
    s = _hjb(4)
    s.name = "m"
    s.train()
    e = _ell(2)
    e.train()
    path = save_exp_logs([s, e], "exp", log_dir=str(tmp_path))
    logs = load_exp_logs(path.split("/")[-1], log_dir=str(tmp_path))
    assert "m" in logs and len(logs["m"]["loss"]) == 4
    assert logs["m"]["u_L2_loss"] == s.u_L2_loss
    assert "V_test_L2" in logs["e"] and "u_L2_loss" not in logs["e"]
