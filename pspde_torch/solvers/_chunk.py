"""Chunked training (counterpart of ``pspde/solvers/_chunk.py``): a solver's
``train()`` runs its L steps in chunks of ``steps_per_call`` steps, with
JAX's resolution of that option, and reads each chunk's metrics once.

On a CUDA solver a chunk of n > 1 steps is one CUDA graph (``StepGraph``):
n calls of the solver's step, captured once and replayed once per full
chunk.  A step decides nothing on the host.  The kernels' seed (drawn from
the solver's CPU seed generator) and each parameter group's learning rate
live in static device buffers, which ``run_training`` fills for the n
steps, in step order, before each replay; the steps' metrics land in the
rows of a device buffer that it reads once after it.  The device
generators that the step draws from are registered with the graph, so that
a replay advances them as n eager steps do.  So a chunk gives what n eager
``step()`` calls give, bitwise: the same ops in the same order on the same
numbers.  On the CPU, which only the tests reach, ``run_training`` runs
the same n steps without capture.  A step whose rollout takes the
sqrt-schedule remat draws each chunk's noise again when it recomputes the
chunk (``rollout/sde.py:_remat_scan``); a capture cannot rewind a
generator, so the warm-up step records each chunk's Philox offset and its
recomputations (``_ForkRecorder``), the capture hands the chunks
generators of their own registered with the graph, and each replay sets
them to the offsets the live generators will have there.

Before its capture the graph runs one eager warm-up step on its stream and
then restores the state the step changed (parameters, Adam's state, the
generators), so that the one-time host work (the kernels' shared-memory
attribute and occupancy queries, Adam's state, library handles) is done
outside the capture.  A step that cannot be captured (a host sync, say)
raises a RuntimeError that names the op; nothing runs eagerly in its
place.  The graph reads the storage of every parameter, buffer, Adam state
tensor and generator as they were at capture: where one has been replaced
since (``load_jax_params`` swaps in a new net and a fresh Adam), the next
replay raises a ValueError naming it (``release_graph()`` drops the graph,
and the next chunk captures anew), and never replays into freed memory.
"""

from __future__ import annotations

import os
import time
import traceback
from datetime import date
from typing import Callable, Optional

import numpy as np
import torch

from ..rollout.sde import chunk_forks, replicas
from ..utils.capture import gc_held
from ..utils.schedule import apply_lr, lr_at

Draws = Optional[Callable[[int], dict]]


def resolve_steps_per_call(solver, chunkable: bool = True) -> int:
    """``steps_per_call`` as pspde resolves it: 'auto' (the default) is
    ``min(50, print_every)`` where the step is ``chunkable`` and 1 where it
    is not; an explicit integer always forces.  Recorded as
    ``solver.resolved_steps_per_call``."""
    spc = getattr(solver, "steps_per_call", 1)
    if spc != "auto":
        resolved = int(spc)
    elif not chunkable:
        resolved = 1
    else:
        resolved = max(1, min(50, int(solver.print_every)))
    solver.resolved_steps_per_call = resolved
    return resolved


def chunk_sizes(total: int, n_steps: int):
    """(chunk, full chunks, remainder) of ``total`` steps in chunks of
    ``n_steps``, the chunk capped at ``total``."""
    n_steps = max(1, min(int(n_steps), total))
    full, rem = divmod(total, n_steps)
    return n_steps, full, rem


def metric_row(metrics: dict) -> torch.Tensor:
    """A step's metrics (0-d tensors, or vectors such as ``log_gradient``'s
    flat gradient) as one float32 row, flattened in their order."""
    return torch.cat([v.detach().to(torch.float32).reshape(-1)
                      for v in metrics.values()])


def metric_layout(metrics: dict) -> list:
    """(name, number of floats, scalar or not) of each metric in a row."""
    return [(k, v.numel(), v.dim() == 0) for k, v in metrics.items()]


def unpack_row(layout: list, row: list) -> dict:
    """A row read back (``metric_row(...).tolist()``) as {name: float, or a
    float32 array for a vector metric}."""
    out, i = {}, 0
    for name, size, scalar in layout:
        out[name] = (row[i] if scalar
                     else np.asarray(row[i:i + size], dtype=np.float32))
        i += size
    return out


class ChunkedSolver:
    """The training steps of a solver, eager (``_eager_step``) and chunked
    (``run_training``).  The solver provides, beside ``L``, ``iteration``,
    ``print_every``, ``verbose``, ``times``, ``optimizer``, ``device``,
    ``steps_per_call`` and ``_seed_gen``:

      * ``_train_step(seed, **draws)``: one step (zero_grad, loss,
        backward, the optimizer's step at the lrs its groups hold) that
        decides nothing on the host and touches no log; returns its
        metrics, a dict of 0-d tensors;
      * ``_lrs``: the groups' lrs (numbers or callables step -> lr);
      * ``_draws_seed``: whether the step takes a kernel seed;
      * ``_record(values)`` (a dict of floats) and ``_maybe_print(done,
        n)``;
      * ``_chunk_modules()`` (name -> trained module) and
        ``_chunk_generators()`` (name -> device generator the step draws
        from).
    """

    _graph = None          # the StepGraph of the last chunked train()
    _seed_word = None      # the eager steps' seed on CUDA

    @property
    def graph_stats(self) -> dict:
        """Warm-up steps, captures and replays of the CUDA graphs this
        solver ran (zeros without one)."""
        if not hasattr(self, "_graph_stats"):
            self._graph_stats = dict(warmup_steps=0, captures=0, replays=0)
        return self._graph_stats

    @property
    def date(self) -> str:
        """Today's date, as pspde stamps its files."""
        return date.today().strftime("%Y-%m-%d")

    # -- persistence (pspde's save_networks etc., solver.py:313-332) ---------
    def save_networks(self, out_dir="output") -> str:
        """The trained modules and the optimizer's state, to
        ``<out_dir>/<name>_<date>`` (``utils/checkpoint.py:save_params``)."""
        from ..utils.checkpoint import save_params
        os.makedirs(out_dir, exist_ok=True)
        path = save_params(os.path.join(out_dir, "%s_%s"
                                        % (self.name, self.date)), self)
        if self.verbose:
            print("\nnetworks data has been stored to: %s" % path)
        return path

    def load_networks(self, path):
        from ..utils.checkpoint import load_params
        load_params(path, self)

    def save_training_state(self, out_dir="output") -> str:
        """The full resume checkpoint: modules, optimizer, generators,
        iteration and logs (``utils/checkpoint.py``)."""
        from ..utils.checkpoint import save_training_state
        os.makedirs(out_dir, exist_ok=True)
        return save_training_state(
            os.path.join(out_dir, "%s_%s_state" % (self.name, self.date)),
            self)

    def load_training_state(self, path):
        from ..utils.checkpoint import load_training_state
        load_training_state(path, self)

    def release_graph(self):
        """Drop the captured graph (and its memory); the next chunked
        ``train()`` captures anew."""
        self._graph = None

    def _host_seed(self) -> Optional[int]:
        """The next kernel seed from the CPU seed generator (None where the
        step takes none)."""
        if not self._draws_seed:
            return None
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._seed_gen))

    def _step_at(self, it: int, draws: dict) -> dict:
        """One eager step at the lrs of step ``it`` and the next kernel
        seed: its metrics (0-d tensors).  Records nothing."""
        apply_lr(self.optimizer, self._lrs, it)
        seed = self._host_seed()
        if seed is not None and self.device.type == "cuda":
            if self._seed_word is None:
                self._seed_word = torch.zeros((), dtype=torch.int64,
                                              device=self.device)
            self._seed_word.fill_(seed)
            seed = self._seed_word
        return self._train_step(seed, **draws)

    def _eager_step(self, draws: dict) -> tuple:
        """One eager step at ``iteration``: (metrics, values), the 0-d
        tensors and their floats (one device-to-host copy).  Records
        nothing."""
        metrics = self._step_at(self.iteration, draws)
        return metrics, unpack_row(metric_layout(metrics),
                                   metric_row(metrics).tolist())

    def _logged_step(self, draws: dict) -> tuple:
        """``_eager_step``, recorded in the logs: iteration advances."""
        metrics, values = self._eager_step(draws)
        self._record(values)
        self.iteration += 1
        return metrics, values

    def _state_tensors(self) -> dict:
        """name -> tensor of what a captured step reads and writes: the
        modules' parameters and buffers and Adam's state."""
        out, names = {}, {}
        for mod_name, mod in self._chunk_modules().items():
            for name, t in list(mod.named_parameters()) + list(
                    mod.named_buffers()):
                out[f"{mod_name}.{name}"] = t
                names[id(t)] = f"{mod_name}.{name}"
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                for key, v in self.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        pname = names.get(id(p), "a parameter")
                        out[f"Adam's {key!r} of {pname}"] = v
        return out


def run_training(solver, stop_check: Optional[Callable[[int], bool]] = None,
                 draws: Draws = None, chunkable: bool = True):
    """Train ``solver`` from ``solver.iteration`` to ``solver.L`` (pspde's
    ``run_training``): chunks of ``resolve_steps_per_call(solver,
    chunkable)`` steps while a full one fits, then single eager steps (all
    single where the step is not ``chunkable``, whatever the option says,
    as pspde's per-step loop); each step's metrics recorded through
    ``solver._record``, ``times`` the chunk's wall time over its steps
    (recording and diagnostics included), the
    print cadence of ``_maybe_print``, and ``stop_check(done)`` (early
    stopping) at chunk boundaries.  ``draws(i)``, where given, is step i's
    injected inputs (``_train_step``'s keyword arguments; the CPU route
    only, which the tests drive on JAX's samples and noise)."""
    L = solver.L
    spc = resolve_steps_per_call(solver, chunkable) if chunkable else 1
    spc, _, _ = chunk_sizes(L, spc)
    solver.resolved_steps_per_call = spc
    done = solver.iteration
    while done < L:
        t0 = time.time()
        if spc > 1 and L - done >= spc:
            rows = _chunk(solver, spc, done, draws)
        else:
            rows = [solver._eager_step(draws(done) if draws else {})[1]]
        n = len(rows)
        for row in rows:
            solver._record(row)
        # the diagnostics that _record runs are timed into their step, as
        # pspde's per-step loop times them
        solver.times.extend([(time.time() - t0) / n] * n)
        done += n
        solver.iteration = done
        solver._maybe_print(done, n)
        if stop_check is not None and stop_check(done):
            break


def _chunk(solver, n: int, done: int, draws: Draws) -> list:
    """The metrics of steps done .. done + n - 1, one dict each."""
    graph = solver._graph
    if graph is None or graph.n != n:
        graph = solver._graph = StepGraph(solver, n)
    return graph.run(done, draws)


def _where(err: BaseException) -> str:
    """The op that raised ``err``: the innermost frame of its traceback
    outside torch's own package (else the innermost), as file:line and
    its source."""
    frames = traceback.extract_tb(err.__traceback__)
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    outside = [f for f in frames
               if not os.path.abspath(f.filename).startswith(torch_dir)]
    f = (outside or frames)[-1]
    return f"{f.filename}:{f.lineno}: {(f.line or '').strip()}"


class _ForkRecorder:
    """The sqrt-schedule chunks of an eager (warm-up) step: for each, in
    order, the generator it forks, that generator's Philox offset at the
    chunk's start from the step's start and the recomputations the chunk
    ran; after ``finish()``, each generator's offset over the whole step.
    The recomputations in the eager step draw from replicas, as without a
    recorder."""

    def __init__(self, generators):
        self.gens = [g for g in generators if g.device.type == "cuda"]
        self.start = {id(g): g.get_offset() for g in self.gens}
        self.forks = []        # [generator, offset, recomputations]
        self.step_offsets = {}

    def __call__(self, gen: torch.Generator):
        if id(gen) not in self.start:
            raise ValueError("a sqrt-schedule chunk draws from a generator "
                             "that the solver's _chunk_generators() does not "
                             "name")
        fork = [gen, gen.get_offset() - self.start[id(gen)], 0]
        self.forks.append(fork)
        again = replicas(gen)

        def counted():
            fork[2] += 1
            return again()

        return counted

    def finish(self):
        self.step_offsets = {id(g): g.get_offset() - self.start[id(g)]
                             for g in self.gens}


class StepGraph:
    """n steps of ``solver`` as one CUDA graph (on the CPU: the same n
    steps run in turn), with the state record that guards its replays."""

    def __init__(self, solver, n: int):
        self.solver, self.n = solver, n
        self.cuda = solver.device.type == "cuda"
        self.record = None       # name -> storage at capture
        self.graph = None

    # -- the state record ---------------------------------------------------
    def _storage(self) -> dict:
        s = self.solver
        out = {name: t.data_ptr() for name, t in s._state_tensors().items()}
        out.update((f"the generator {name}", id(g))
                   for name, g in s._chunk_generators().items())
        return out

    def _check(self):
        now = self._storage()
        for name, ptr in self.record.items():
            if now.get(name) != ptr:
                raise ValueError(
                    f"{type(self.solver).__name__}: the captured "
                    f"{self.n}-step graph reads {name}, which was replaced "
                    "since its capture (load_jax_params and a new optimizer "
                    "replace the net and Adam's state): call "
                    "release_graph() to capture anew")

    # -- a chunk ------------------------------------------------------------
    def run(self, done: int, draws: Draws) -> list:
        if self.record is not None:
            self._check()
        if not self.cuda:
            rows = self._run_eager(done, draws)
        else:
            if draws is not None:
                raise ValueError("injected inputs (draws) run on the CPU "
                                 "route only; a CUDA chunk draws its own")
            if self.graph is None:
                self._capture()
            rows = self._replay(done)
        if self.record is None:
            self.record = self._storage()
        return rows

    def _run_eager(self, done: int, draws: Draws) -> list:
        """The CPU route: the n steps in turn, their metrics read once."""
        s = self.solver
        steps = [s._step_at(i, draws(i) if draws else {})
                 for i in range(done, done + self.n)]
        rows = torch.stack([metric_row(m) for m in steps]).tolist()
        return [unpack_row(metric_layout(m), r) for m, r in zip(steps, rows)]

    def _replay(self, done: int) -> list:
        s, n = self.solver, self.n
        for i in range(n):
            seed = s._host_seed()
            if seed is not None:
                self.seed_host[i] = seed
            for j, lr in enumerate(s._lrs):
                self.lr_host[j, i] = lr_at(lr, done + i)
        if self.seed_buf is not None:
            self.seed_buf.copy_(self.seed_host, non_blocking=True)
        self.lr_buf.copy_(self.lr_host, non_blocking=True)
        # each chunk's generator at the offset its generator will have at
        # the chunk's start in this replay
        for i, gen, start, shadow in self.shadows:
            shadow.manual_seed(gen.initial_seed())
            shadow.set_offset(gen.get_offset()
                              + i * self.step_offsets[id(gen)] + start)
        self.graph.replay()
        s.graph_stats["replays"] += 1
        return [unpack_row(self.layout, r) for r in self.out_buf.tolist()]

    # -- capture ------------------------------------------------------------
    def _snapshot(self):
        s = self.solver
        tensors = [(t, t.detach().clone())
                   for t in s._state_tensors().values()]
        gens = [(g, g.get_state()) for g in s._chunk_generators().values()]
        return tensors, gens

    def _restore(self, snap):
        """Undo the warm-up step: the parameters, buffers and Adam state it
        found back in place, Adam's state it created zeroed (Adam's fresh
        state is zeros), the generators' states, no gradients."""
        s = self.solver
        tensors, gens = snap
        found = {id(t) for t, _ in tensors}
        with torch.no_grad():
            for t, old in tensors:
                t.copy_(old)
            for t in s._state_tensors().values():
                if id(t) not in found:
                    t.zero_()
        for g, state in gens:
            g.set_state(state)
        s.optimizer.zero_grad(set_to_none=True)

    def _capture(self):
        s, n, dev = self.solver, self.n, self.solver.device
        groups = s.optimizer.param_groups
        self.seed_buf = (torch.zeros((n,), dtype=torch.int64, device=dev)
                         if s._draws_seed else None)
        self.seed_host = torch.zeros((n,), dtype=torch.int64).pin_memory()
        self.lr_buf = torch.zeros((len(groups), n), dtype=torch.float32,
                                  device=dev)
        self.lr_host = torch.zeros((len(groups), n),
                                   dtype=torch.float32).pin_memory()
        seed = None if self.seed_buf is None else self.seed_buf[0]

        # the warm-up step, on the capture's stream after the snapshot's
        # copies, then undone
        snap = self._snapshot()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        forks = _ForkRecorder(s._chunk_generators().values())
        with torch.cuda.stream(stream), chunk_forks(forks):
            metrics = s._train_step(seed)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        forks.finish()
        self._restore(snap)
        s.graph_stats["warmup_steps"] += 1
        self.layout = metric_layout(metrics)
        width = sum(size for _, size, _ in self.layout)
        self.out_buf = torch.zeros((n, width), dtype=torch.float32,
                                   device=dev)
        del metrics, snap

        graph = torch.cuda.CUDAGraph()
        for g in s._chunk_generators().values():
            graph.register_generator_state(g)
        # a generator, registered, for each recomputation of each
        # sqrt-schedule chunk of the n steps (rollout/sde.py:_remat_scan),
        # set before each replay
        chunks = [(i, gen, start, [torch.Generator(device=dev)
                                   for _ in range(calls)])
                  for i in range(n) for gen, start, calls in forks.forks]
        self.shadows = [(i, gen, start, g) for i, gen, start, gens in chunks
                        for g in gens]
        for *_, shadow in self.shadows:
            graph.register_generator_state(shadow)
        self.step_offsets = forks.step_offsets
        chunks = iter(chunks)

        def shadow_of(gen):
            _, want, _, gens = next(chunks)
            if want is not gen:
                raise RuntimeError("the captured step forks its generators "
                                   "in another order than its warm-up step")
            return iter(gens).__next__

        saved_lrs = [group["lr"] for group in groups]
        sync_mode = torch.cuda.get_sync_debug_mode()
        i = 0
        try:
            with gc_held(), torch.cuda.graph(graph, stream=stream), \
                    chunk_forks(shadow_of):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for i in range(n):
                        for j, group in enumerate(groups):
                            group["lr"] = self.lr_buf[j, i]
                        seed = (None if self.seed_buf is None
                                else self.seed_buf[i])
                        m = s._train_step(seed)
                        self.out_buf[i].copy_(metric_row(m))
                finally:
                    torch.cuda.set_sync_debug_mode(sync_mode)
        except RuntimeError as err:
            raise RuntimeError(
                f"{type(s).__name__}(steps_per_call={n}): step {i} of the "
                f"chunk cannot be captured in a CUDA graph at "
                f"{_where(err)}: {err}") from err
        finally:
            for group, lr in zip(groups, saved_lrs):
                group["lr"] = lr
        self.graph = graph
        s.graph_stats["captures"] += 1
        s.optimizer.zero_grad(set_to_none=True)


__all__ = ["ChunkedSolver", "StepGraph", "chunk_sizes", "metric_layout",
           "metric_row", "resolve_steps_per_call", "run_training",
           "unpack_row"]
