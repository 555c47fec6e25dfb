"""The port's chunked training (``pspde_torch/solvers/_chunk.py``) against
pspde's (``pspde/solvers/_chunk.py``) and against its own per-step
training, on the CPU.

On the CPU ``run_training`` runs a chunk's n steps in turn (on CUDA they
are one captured CUDA graph, held to the eager steps bitwise by
``chip_smoke.py``'s phase 36).  The tests hold:

  * ``resolve_steps_per_call`` and ``chunk_sizes`` to pspde's over a grid
    of (steps_per_call, print_every, L, chunkable), and each solver's
    ``resolved_steps_per_call`` after ``train()`` to the JAX solver's for
    the same options, HJBSolver's gate included (a loss with phases
    trains one step per call);
  * chunked ``train()`` to per-step ``train()`` for each solver and engine
    (the kernels' plain versions for 'fused_train'), PINN too, at
    tests/test_chunked_and_sharding.py's configs and chunk sizes with L =
    2 chunks + a remainder: logs and parameters exactly equal (the same
    ops on the same numbers; JAX's own test holds rtol 1e-4);
  * 20 steps through ``run_training`` at n=8 on the JAX steps' own samples and
    noise against JAX's 20 single steps, at the 20-step tests' tolerances
    (elliptic: loss 2e-4, parameters atol 1e-5; eigen: 2e-4, 2e-5; HJB:
    1e-3, 2e-5);
  * the stale-state ValueError after ``load_jax_params``;
  * the training kernels' seed handed to the library as the pointer of a
    0-d int64 word (a fake library), the same word to a call's forward and
    backward, the serve's seed by value.
"""

import ctypes
import types
import warnings

import jax
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_boundary_reflected as j_reflected
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import (EigenSolver as JEigen, EllipticSolver as JEll,
                           HJBSolver as JHJB)
from pspde.solvers._chunk import chunk_sizes as j_chunk_sizes
from pspde.solvers._chunk import resolve_steps_per_call as j_resolve
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import _build
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import (EigenSolver, EllipticSolver, GeneralSolver,
                                 HJBSolver)
from pspde_torch.solvers._chunk import chunk_sizes as t_chunk_sizes
from pspde_torch.solvers._chunk import resolve_steps_per_call as t_resolve
from pspde_torch.solvers._chunk import run_training
from pspde_torch.utils.convert import (dense_net_to_flax,
                                       eigen_params_to_flax,
                                       tanh_mlp_state_dict)


# -- resolution -------------------------------------------------------------

@pytest.mark.parametrize("spc", ["auto", 1, 3, 7, 50, 64])
def test_resolution_matches_pspde(spc):
    for print_every in (1, 5, 49, 100):
        for chunkable in (True, False):
            a = types.SimpleNamespace(steps_per_call=spc,
                                      print_every=print_every)
            b = types.SimpleNamespace(steps_per_call=spc,
                                      print_every=print_every)
            got, want = t_resolve(a, chunkable), j_resolve(b, chunkable)
            assert got == want == a.resolved_steps_per_call \
                == b.resolved_steps_per_call
            for L in (1, 6, 50, 123):
                assert t_chunk_sizes(L, got) == j_chunk_sizes(L, want)


def _small(kind, jax_side, **kw):
    """tests/test_chunked_and_sharding.py's configs, on either side."""
    if kind == "hjb":
        p = jp.LLGC(d=3, T=0.5) if jax_side else tp.LLGC(d=3, T=0.5,
                                                          device="cpu")
        args = dict(lr=1e-2, K=64, delta_t=0.1, time_approx="inner",
                    learn_Y_0=True, verbose=False, early_stopping_time=None)
        args.update(kw)
        if jax_side:
            return JHJB("h", p, **args)
        return HJBSolver("h", p, device="cpu", **args)
    if kind == "eigen":
        p = (jp.FokkerPlanckEigen(d=2) if jax_side
             else tp.FokkerPlanckEigen(d=2, device="cpu"))
        args = dict(K=64, K_boundary=16, N=5, delta_t=1e-3, verbose=False)
        args.update(kw)
        if jax_side:
            return JEigen(p, "f", **args)
        return EigenSolver(p, "f", device="cpu", **args)
    p = (jp.ExponentialOnSphere(d=4) if jax_side
         else tp.ExponentialOnSphere(d=4, device="cpu"))
    args = dict(K=64, K_boundary=16, N=8, delta_t=1e-2, verbose=False)
    args.update(kw)
    if jax_side:
        return JEll(p, "e", **args)
    return EllipticSolver(p, "e", device="cpu", **args)


@pytest.mark.parametrize("kind,kw,want", [
    ("elliptic", dict(L=6), 6),
    ("elliptic", dict(L=7, print_every=3), 3),
    ("eigen", dict(L=5, steps_per_call=2), 2),
    ("hjb", dict(L=5, loss_method="log-variance"), 5),
    ("hjb", dict(L=3, loss_method="relative_entropy_log-variance"), 1),
    ("hjb", dict(L=3, loss_method="relative_entropy_log-variance",
                 steps_per_call=2), 1),
])
def test_solver_resolution_matches_jax(kind, kw, want):
    """After train(), resolved_steps_per_call as JAX's: the chunk capped at
    L, print_every's cap, an explicit value, and HJBSolver's gate (a loss
    with phases runs one step per call, an explicit value too)."""
    js, ts = _small(kind, True, **kw), _small(kind, False, **kw)
    js.train()
    ts.train()
    assert ts.resolved_steps_per_call == js.resolved_steps_per_call == want
    assert len(ts.loss_log) == len(js.loss_log) == kw["L"]


# -- chunked == per-step ----------------------------------------------------

def _port(kind, engine, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if kind == "general":
            s = GeneralSolver(tp.ExponentialOnSphereParabolic(d=4,
                                                              device="cpu"),
                              "g", K=64, K_boundary=16, N=8, delta_t=1e-2,
                              verbose=False, device="cpu",
                              rollout_mode=engine, **kw)
        else:
            s = _small(kind, False, rollout_mode=engine, **kw)
    # the CPU has no kernels: drive the fused step through its plain
    # versions (per-step seeds from the seed generator)
    s.resolved_rollout_mode = engine
    return s


def _state(s):
    mods = s._chunk_modules()
    return {f"{m}.{n}": p.detach().clone() for m, mod in mods.items()
            for n, p in mod.named_parameters()}


_LOGS = {"hjb": ("loss_log", "u_L2_loss", "Y_0_log"),
         "elliptic": ("loss_log", "V_L2_log", "K_log", "V_test_L2",
                      "loss_log_domain", "loss_log_boundary"),
         "general": ("loss_log", "V_L2_log", "K_log", "V_test_L2"),
         "eigen": ("loss_log", "lambda_log", "V_L2_log", "loss_log_center",
                   "loss_log_boundary", "loss_log_derivative_boundary",
                   "loss_log_domain")}


# logs kept only with an option (learn_Y_0, K_test_log, log_loss_parts)
_OPTIONAL = ("Y_0_log", "V_test_L2", "loss_log_domain", "loss_log_boundary")


@pytest.mark.parametrize("kind,engine,n,kw", [
    ("elliptic", "scan", 4, dict(K_test_log=128, log_loss_parts=True)),
    ("elliptic", "fused_train", 4, dict(K_test_log=128)),
    ("elliptic", "scan", 4, dict(loss_method="PINN", K_test_log=128)),
    ("general", "scan", 5, dict(K_test_log=128)),
    ("general", "fused_train", 5, dict(K_test_log=128)),
    ("general", "scan", 5, dict(loss_method="PINN")),
    ("eigen", "scan", 10, dict()),
    ("eigen", "fused_train", 10, dict(normalization="l2_penalty")),
    ("hjb", "scan", 5, dict(loss_method="log-variance")),
    ("hjb", "fused_train", 5, dict(loss_method="log-variance",
                                   detach_forward=True,
                                   rollout_mode="fused_train")),
])
def test_chunked_train_equals_per_step(kind, engine, n, kw):
    kw = dict(kw)
    kw.pop("rollout_mode", None)
    L = 2 * n + 2
    one = _port(kind, engine, L=L, steps_per_call=1, **kw)
    one.train()
    many = _port(kind, engine, L=L, steps_per_call=n, **kw)
    many.train()
    assert one.resolved_steps_per_call == 1
    assert many.resolved_steps_per_call == n
    for name in _LOGS[kind]:
        a, b = getattr(one, name), getattr(many, name)
        if name in _OPTIONAL and not a and not b:
            continue
        assert len(a) == len(b) == L, name
        # equal as arrays: NaN (V_L2 without an in-kernel reference) too
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(many.times) == L and many.iteration == L
    for (k, a), b in zip(_state(one).items(), _state(many).values()):
        assert torch.equal(a, b), k
    if engine == "fused_train":
        # both drew one kernel seed a step from the seed generator
        assert torch.equal(one._seed_gen.get_state(),
                           many._seed_gen.get_state())


def test_early_stop_at_chunk_boundaries():
    """HJBSolver's plateau rule reads u_L2 at chunk boundaries only (as
    pspde's run_training): a rule that fires from the start stops after
    the first full chunk."""
    s = _port("hjb", "scan", L=12, steps_per_call=5,
              loss_method="log-variance")
    s.early_stopping_time = 1
    s._early_stop = lambda done: done > 1
    s.train()
    assert len(s.loss_log) == 5 and s.iteration == 5


@pytest.mark.parametrize("loss_method,steps_per_call", [
    ("relative_entropy_log-variance", 4), ("log-variance", 1)])
def test_hjb_per_step_loop(capsys, loss_method, steps_per_call):
    """Where pspde's HJBSolver runs its per-step loop (a loss with phases,
    whatever steps_per_call says, or one step a call), the port's train()
    does what that loop does: one step at a time, the print at steps l
    with l % print_every == 0 and the plateau rule checked after step l as
    _early_stop(l)."""
    s = _port("hjb", "scan", L=12, steps_per_call=steps_per_call,
              loss_method=loss_method)
    s.verbose, s.print_every = True, 2
    seen = []
    s._early_stop = lambda l: seen.append(l) or l > 4
    s.train()
    assert s.resolved_steps_per_call == 1 and s._stepwise
    assert len(s.loss_log) == 6 and s.iteration == 6 and seen == list(
        range(6))
    printed = [int(line.split(" - ")[0]) for line in
               capsys.readouterr().out.splitlines() if " - loss: " in line]
    assert printed == [0, 2, 4]


# -- 20 steps through run_training against JAX -----------------------------

STEPS, CHUNK = 20, 8


def _elliptic_draws(key, geom, K, KB, N, D):
    kb, kd, kr = jax.random.split(key, 3)
    Xb = np.asarray(j_boundary(kb, geom, KB, D))
    X0 = np.asarray(j_domain(kd, geom, K, D))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    return dict(X0=torch.tensor(X0), Xb=torch.tensor(Xb),
                host_noise=torch.tensor(noise))


def _eigen_draws(key, geom, K, KB, N, D):
    kb, kd, kr, kn = jax.random.split(key, 4)
    Xb, Xb_r = (torch.tensor(np.asarray(a))
                for a in j_reflected(kb, geom, KB, D))
    X0 = np.asarray(j_domain(kd, geom, K, D))
    X2 = np.asarray(j_domain(kn, geom, K, D))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    return dict(X0=torch.tensor(X0), Xb=(Xb, Xb_r), X2=torch.tensor(X2),
                host_noise=torch.tensor(noise))


def _hjb_draws(key, K, N, D):
    _, kr = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D), dtype=jax.numpy.float32))
        for n in range(N)])
    return dict(host_noise=torch.from_numpy(noise))


@pytest.mark.parametrize("kind,engine", [("elliptic", "scan"),
                                         ("elliptic", "fused_train"),
                                         ("eigen", "fused_train"),
                                         ("hjb", "fused_train")])
def test_twenty_chunked_steps_match_jax(kind, engine):
    if kind == "elliptic":
        D, K, KB, N = 4, 64, 16, 16
        kw = dict(delta_t=0.01, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
                  verbose=False)
        pj = jp.ExponentialOnBallNonlinearSin(d=D, alpha=0.5)
        pt = tp.ExponentialOnBallNonlinearSin(d=D, alpha=0.5, device="cpu")
        js = JEll(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)), **kw)
        step = jax.jit(js._build_step())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ts = EllipticSolver(pt, "t", rollout_mode=engine, device="cpu",
                                steps_per_call=CHUNK, **kw)
            ts.load_jax_params(jax.device_get(js.params))

        def draws_of(sub):
            return _elliptic_draws(sub, pj.geometry, K, KB, N, D)
        logs, rtol, atol = (("loss", "loss_log"), ("V_L2", "V_L2_log")), \
            2e-4, 1e-5
    elif kind == "eigen":
        D, K, KB, N = 5, 64, 16, 16
        kw = dict(delta_t=0.01, N=N, L=STEPS, K=K, K_boundary=KB,
                  verbose=False, lr=1e-3, lr_lambda=0.01,
                  normalization="l2_penalty")
        pj = jp.FokkerPlanckEigen(d=D)
        pt = tp.FokkerPlanckEigen(d=D, device="cpu")
        js = JEigen(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)),
                    **kw)
        step = jax.jit(js._build_step())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ts = EigenSolver(pt, "t", rollout_mode=engine, device="cpu",
                             value_net=DenseNet(1, (8, 8), d_in=D,
                                                device="cpu"),
                             steps_per_call=CHUNK, **kw)
            ts.load_jax_params(jax.device_get(js.params))

        def draws_of(sub):
            return _eigen_draws(sub, pj.geometry, K, KB, N, D)
        logs, rtol, atol = (("loss", "loss_log"), ("lambda", "lambda_log"),
                            ("V_L2", "V_L2_log")), 2e-4, 2e-5
    else:
        D, K, N = 6, 64, 12
        kw = dict(lr=1e-2, L=STEPS, K=K, delta_t=1.0 / 12,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, learn_Y_0=True, verbose=False,
                  early_stopping_time=None)
        js = JHJB("j", jp.LLGC(d=D, T=1.0), **kw)
        step = jax.jit(js._build_step(0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ts = HJBSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"),
                           rollout_mode=engine, device="cpu",
                           steps_per_call=CHUNK, **kw)
            ts.load_jax_params(jax.device_get(js.params))

        def draws_of(sub):
            return _hjb_draws(sub, K, N, D)
        logs, rtol, atol = (("loss", "loss_log"), ("u_l2", "u_L2_loss")), \
            1e-3, 2e-5
    ts.resolved_rollout_mode = engine
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    want = {k: [] for k, _ in logs}
    draws = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        draws.append(draws_of(sub))
        params, opt, aux = step(params, opt, sub)
        for k in want:
            want[k].append(float(aux[k]))
    run_training(ts, draws=lambda i: draws[i])
    assert ts.resolved_steps_per_call == CHUNK and ts.iteration == STEPS
    for k, name in logs:
        np.testing.assert_allclose(getattr(ts, name), want[k], rtol=rtol,
                                   err_msg=k)
    params = jax.device_get(params)
    if kind == "elliptic":
        got = jax.tree.leaves(dense_net_to_flax(list(
            ts.V_net.parameters())))
        ref = jax.tree.leaves(params)
    elif kind == "eigen":
        got = jax.tree.leaves(eigen_params_to_flax(
            list(ts.V_net.parameters()), ts.lam_net.Y_0))
        ref = jax.tree.leaves(params)
    else:
        sd = ts.z_net.state_dict()
        ref_sd = tanh_mlp_state_dict(params["z"])
        got = [sd[k].numpy() for k in ref_sd]
        ref = [v.numpy() for v in ref_sd.values()]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol)


# -- stale state ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["elliptic", "eigen", "hjb"])
def test_stale_state_raises(kind):
    """A chunked train() after load_jax_params (a new net and a fresh Adam)
    raises a ValueError naming the replaced tensor; release_graph() lets
    the next chunk start anew, and a train() with nothing replaced goes
    on."""
    kw = (dict(loss_method="log-variance") if kind == "hjb" else {})
    s = _port(kind, "scan", L=8, steps_per_call=4, **kw)
    s.train()
    s.L = 12
    s.train()                       # nothing replaced: the record holds
    if kind == "elliptic":
        tree = dense_net_to_flax(list(s.V_net.parameters()))
        name = "V_net."
    elif kind == "eigen":
        tree = eigen_params_to_flax(list(s.V_net.parameters()),
                                    s.lam_net.Y_0)
        name = "V_net."
    else:
        from pspde_torch.utils.convert import tanh_mlp_to_flax
        tree = {"z": tanh_mlp_to_flax(list(s.z_net.parameters())),
                "y0": {"params": {"Y_0": s.y0_net.Y_0.detach().numpy()}}}
        name = "z_net."
    s.load_jax_params(tree)
    s.L = 16
    with pytest.raises(ValueError, match="replaced") as err:
        s.train()
    assert name in str(err.value) and "release_graph" in str(err.value)
    assert len(s.loss_log) == 12
    s.release_graph()
    s.train()
    assert len(s.loss_log) == 16 and s.iteration == 16


# -- the seed in device memory ----------------------------------------------

def test_bind_declares_the_seed_pointer():
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in (
            "pspde_controlled_rollout", "pspde_train_rollout_fwd",
            "pspde_train_rollout_bwd", "pspde_stopped_rollout_fwd",
            "pspde_stopped_rollout_fwd_block",
            "pspde_stopped_rollout_bwd", "pspde_ablation", "pspde_fma_chain",
            "pspde_normals_sum", "pspde_stopped_bwd_slots",
            "pspde_train_fwd_occupancy", "pspde_stopped_fwd_occupancy",
            "pspde_stopped_fwd_block_occupancy",
            "pspde_serve_occupancy", "pspde_cuda_error_string")})
    _build.bind(lib)
    assert lib.pspde_controlled_rollout.argtypes[-3] is ctypes.c_ulonglong
    for name in tk._DEVICE_SEED_ENTRIES:
        # the seed's pointer, then the launch count's
        types_ = getattr(lib, name).argtypes
        assert types_[-4:-2] == [ctypes.c_void_p, ctypes.c_void_p], name
        assert types_[-6:-4] == [ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_float)]


def test_device_seed_words():
    for seed in (0, 17, 2 ** 31 - 2, 2 ** 40 + 3, 2 ** 63 + 5, -1):
        w = tk.device_seed(seed, torch.device("cpu"))
        assert w.dtype == torch.int64 and w.dim() == 0
        assert int(w) & tk._M64 == seed & tk._M64
        assert tk.device_seed(w, torch.device("cpu")) is w
        assert tk.host_seed(w) & tk._M64 == seed & tk._M64
    with pytest.raises(ValueError, match="0-d int64"):
        tk.device_seed(torch.zeros(2, dtype=torch.int64), torch.device("cpu"))
    with pytest.raises(ValueError, match="0-d int64"):
        tk.device_seed(torch.zeros((), dtype=torch.int32),
                       torch.device("cpu"))


class _FakeLib:
    """Records each training entry's seed argument and the 64-bit word it
    points at (read while the launch is on), and runs the launch's count
    (adds one to the word its count argument points at, as the kernel's
    block 0 does)."""

    def __init__(self):
        self.seeds = []

    def _entry(self, name):
        def fn(*args):
            seed, count = args[-4], args[-3]
            self.seeds.append((name, seed,
                               ctypes.c_uint64.from_address(seed).value))
            ctypes.c_uint64.from_address(count).value += 1
            return 0
        return fn

    def __getattr__(self, name):
        if name in tk._DEVICE_SEED_ENTRIES:
            return self._entry(name)
        if name == "pspde_stopped_fwd_occupancy":
            def occ(iargs, fargs, index, out):
                out[0], out[1], out[2], out[3] = 2, 64, 1024, 4
                return 0
            return occ
        if name == "pspde_stopped_bwd_slots":
            def slots(iargs, fargs, index, out):
                out._obj.value = 3
                return 0
            return slots
        raise AttributeError(name)


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tk, "_STOPPED_BWD_SLOTS", {})
    monkeypatch.setattr(tk, "_STOPPED_FWD_OCC", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_training_kernels_read_one_seed_word(fake_lib):
    """Each of the four training entries gets the pointer of a 0-d int64
    word holding the seed: a call's forward and backward the same word
    (the slot a captured graph writes before each replay), an int seed a
    word of its own with its value."""
    dev = torch.device("cpu")
    prob = tp.LLGC(d=3, T=0.5, device="cpu")
    from pspde_torch.ansatz import TanhMLP
    net = TanhMLP(4, 3, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    fams = tk._check_train_family(prob, net, 5, 1.0, None, "binom")
    word = tk.device_seed(2 ** 33 + 7, dev)
    opts = dict(adaptive_forward=True, accumulate_kl=False,
                kl_ito_term=False, u_tab=None, rng="binom", noise_sign=1.0,
                host_noise=None)
    call = tk._TrainCall(prob, net, 32, 5, 0.1, word, fams, opts, None)
    tk._train_forward_kernel(call)
    gY = torch.zeros(32)
    tk._train_backward_kernel(call, gY, gY)
    sprob = tp.ExponentialOnBallNonlinearSin(d=4, alpha=0.5, device="cpu")
    vnet = DenseNet(1, (8, 8), d_in=4, device="cpu")
    sfams = tk._check_stopped_family(sprob, vnet, "erfinv")
    X0 = torch.zeros((40, 4))
    scall = tk._StoppedCall(sprob, vnet, X0, torch.zeros(40), 6, 0.01, word,
                            sfams, dict(adaptive_forward=False, rng="erfinv",
                                        host_noise=None), None)
    tk._stopped_forward_launch(scall)
    tk._stopped_backward_rows(scall, torch.zeros(40))
    names = [n for n, _, _ in fake_lib.seeds]
    assert names == ["pspde_train_rollout_fwd", "pspde_train_rollout_bwd",
                     "pspde_stopped_rollout_fwd",
                     "pspde_stopped_rollout_bwd"]
    assert all(ptr == word.data_ptr() and value == 2 ** 33 + 7
               for _, ptr, value in fake_lib.seeds)
    fake_lib.seeds.clear()
    tk._train_forward_kernel(call._replace(seed=12345))
    (_, ptr, value), = fake_lib.seeds
    assert ptr != word.data_ptr() and value == 12345


def _four_launches(word):
    """One launch of each training entry on the CPU (the fake library):
    the HJB pair at K=32, the stopped pair at K=40, the stopped backward
    on its device plan."""
    from pspde_torch.ansatz import TanhMLP
    prob = tp.LLGC(d=3, T=0.5, device="cpu")
    net = TanhMLP(4, 3, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    fams = tk._check_train_family(prob, net, 5, 1.0, None, "binom")
    opts = dict(adaptive_forward=True, accumulate_kl=False,
                kl_ito_term=False, u_tab=None, rng="binom", noise_sign=1.0,
                host_noise=None)
    call = tk._TrainCall(prob, net, 32, 5, 0.1, word, fams, opts, None)
    tk._train_forward_kernel(call)
    tk._train_backward_kernel(call, torch.zeros(32), torch.zeros(32))
    sprob = tp.ExponentialOnBallNonlinearSin(d=4, alpha=0.5, device="cpu")
    vnet = DenseNet(1, (8, 8), d_in=4, device="cpu")
    sfams = tk._check_stopped_family(sprob, vnet, "erfinv")
    scall = tk._StoppedCall(sprob, vnet, torch.zeros((40, 4)),
                            torch.zeros(40), 6, 0.01, word, sfams,
                            dict(adaptive_forward=False, rng="erfinv",
                                 host_noise=None), None, plan="device")
    tk._stopped_forward_launch(scall)
    tk._stopped_backward_rows(scall, torch.zeros(40))
    return tk._plan_of(call.pack(backward=False))


def test_training_kernels_count_their_launches(fake_lib, monkeypatch):
    """Each training entry gets the pointer of its own count word (its
    entry's and plan's, one set a device), which the launch adds one to;
    kernel_launch_counts reads the words back, keyed as launch_counts,
    with the totals; reset_launch_counts zeroes words and wrappers'
    counts."""
    monkeypatch.setattr(tk, "_COUNT_WORDS", {})
    tk.reset_launch_counts()
    plan = _four_launches(tk.device_seed(5, torch.device("cpu")))
    (words,) = tk._COUNT_WORDS.values()
    assert int(words.sum()) == 4 and len(words) == len(tk._COUNT_KEYS)
    got = tk.kernel_launch_counts()
    want = {("fused_train_rollout", "launches"): 1,
            ("fused_train_rollout", "launches_by_plan", plan): 1,
            ("fused_train_rollout", "backward_launches"): 1,
            ("fused_train_rollout", "backward_launches_by_plan", plan): 1,
            ("fused_stopped_train_rollout", "launches"): 1,
            ("fused_stopped_train_rollout", "launches_by_kernel", "lanes"): 1,
            ("fused_stopped_train_rollout", "backward_launches"): 1,
            ("fused_stopped_train_rollout", "backward_launches_by_plan",
             "device"): 1}
    assert {k: v for k, v in got.items() if v} == want
    host = tk.launch_counts()
    assert all(host[k] == v for k, v in want.items())
    tk.reset_launch_counts()
    assert not any(tk.kernel_launch_counts().values())
    assert not any(tk.launch_counts().values())


def test_launches_in_a_capture(fake_lib, monkeypatch):
    """A launch recorded in a CUDA graph's capture counts on the device
    (when the graph runs it), not in the wrapper's counts; the count words
    are made at an eager launch, never in a capture."""
    monkeypatch.setattr(tk, "_COUNT_WORDS", {})
    tk.reset_launch_counts()
    monkeypatch.setattr(tk, "_capturing", lambda dev: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph's capture"):
        _four_launches(tk.device_seed(5, torch.device("cpu")))
    monkeypatch.setattr(tk, "_capturing", lambda dev: False)
    _four_launches(tk.device_seed(5, torch.device("cpu")))
    tk.reset_launch_counts()
    monkeypatch.setattr(tk, "_capturing", lambda dev: True)
    _four_launches(tk.device_seed(5, torch.device("cpu")))
    assert not any(tk.launch_counts().values())
    assert tk.kernel_launch_counts()[("fused_train_rollout", "launches")] == 1
    assert sum(tk._COUNT_WORDS[torch.device("cpu")].tolist()) == 4


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_held_around_a_capture(enabled):
    """``gc_held`` (which wraps every capture in the port) collects the
    dead cycles made before it, collects none inside it however many
    objects the block makes, and gives back the collector's earlier state,
    also when the block raises."""
    import gc
    import weakref

    from pspde_torch.utils.capture import gc_held

    class Node:
        pass

    def dead_cycle():
        a, b = Node(), Node()
        a.other, b.other = b, a
        return weakref.ref(a)

    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        before = dead_cycle()
        with pytest.raises(KeyError):
            with gc_held():
                assert before() is None and not gc.isenabled()
                inside = dead_cycle()
                junk = [[Node()] for _ in range(50_000)]
                assert inside() is not None
                del junk
                raise KeyError("the block raises")
        assert gc.isenabled() == enabled
        gc.collect()
        assert inside() is None
    finally:
        (gc.enable if was else gc.disable)()
