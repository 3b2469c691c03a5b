"""The user-facing facade: problem container + solve lifecycle.

Counterpart of ``etol_tpu/optimizer.py``. Parity with the reference's
abstract core class (``include/ETOL/TrajectoryOptimizer.hpp:27``,
lifecycle ``setup() / solve() / debug() / close()`` at :39-54) — but
where the reference dispatches to one of six solver plugins through
type-erased callbacks, this facade freezes the problem once into tensors
on one device and runs the native AL-SQP there.

* The device is the card unless the constructor is given one
  (``device="cpu"`` for a rehearsal); where CUDA is absent and no device
  is given, :meth:`setup` raises.
* Callbacks are plain functions ``f(x, u, t, data)`` on tensors — one
  definition serves values, gradients, Jacobians (``torch.func``) and
  batching (the reference needs a dialect per backend, SURVEY.md §1).
* :meth:`solve_batch` takes a fleet; per-problem status rides in the
  result (the reference exits the process on failure).
* The receding-horizon fast path (eGurobi change-flag machinery,
  eGurobi.cpp:419-453,457-597) is :meth:`set_x0` + :meth:`mpc_step`:
  a new x0 swaps one tensor, and the re-solve is warm-started from the
  shifted previous solution. Under the default ``kkt_solver="kernel"``
  every Newton iteration of :meth:`solve` and :meth:`mpc_step` is one
  launch of the KKT kernel at a batch of one.
* :meth:`solve`, :meth:`mpc_step` and :meth:`solve_batch` open a root
  span each (``facade.solve``, ``facade.mpc_step``,
  ``facade.solve_batch``) while the span recorder of
  ``utils/profiling.py`` is on, with ``facade.prepare`` (the new start,
  the tracks' and the warm start's shift), the solve's own spans and
  ``facade.sync`` (the wait for the card) under it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import trajectory
from .core.device import resolve
from .core.problem import VGP, VGPData, batch_tile, tree_map
from .core.types import Dims, Status
from .core.xml_io import load_configs as _load, save_configs as _save
from .solve import al_sqp
from .solve.al_sqp import SolveResult, SolverConfig
from .transcribe.nlp import NLP
from .utils import profiling


def _warm_state(res: SolveResult) -> Tuple:
    """What a re-solve starts from: z, the multipliers, the penalty."""
    return res.z, (res.lam_def, res.lam_eq, res.mu), res.rho


class TrajectoryOptimizer:
    """Problem container + native batched solver facade."""

    def __init__(
        self,
        config: Optional[SolverConfig] = None,
        dtype=torch.float32,
        device=None,
    ):
        self.vgp = VGP()
        self.config = config or SolverConfig()
        self.dtype = dtype
        self.device = device  # None: the card, resolved at setup()
        self._dynamics: Optional[Callable] = None
        self._objective: Optional[Callable] = None
        self._terminal: Optional[Callable] = None
        self._path_ineq: list = []
        self._path_eq: list = []
        self._maximize = False
        self._scheme = "trapezoidal"
        self._cost_form = "integral"
        self.nlp: Optional[NLP] = None
        self.data: Optional[VGPData] = None
        self.dims: Optional[Dims] = None
        self.result: Optional[SolveResult] = None
        self.batch_result: Optional[SolveResult] = None
        self._warm: Optional[Tuple] = None
        self._warm_batch: Optional[Tuple] = None
        self._solve_time = 0.0
        self.mip_result = None

    # ---- configuration (reference setter parity) ----------------------
    def load_configs(self, path: str) -> "TrajectoryOptimizer":
        """XML problem load (loadConfigs, TrajectoryOptimizer.cpp:787)."""
        self.vgp = _load(path)
        return self

    def save_configs(self, path: str) -> str:
        """XML problem save (saveConfigs, TrajectoryOptimizer.cpp:1119)."""
        return _save(self.vgp, path)

    def set_dynamics(self, f: Callable) -> None:
        """The reference's setGradient (TrajectoryOptimizer.hpp:545-553):
        one function xdot = f(x, u, t, data) on tensors instead of
        per-state callbacks."""
        self._dynamics = f

    # reference name kept as an alias
    set_gradient = set_dynamics

    def set_objective(self, ell: Callable, form: str = "integral") -> None:
        """setObjective parity (TrajectoryOptimizer.hpp:537-543);
        ``form`` is "integral" (NLP backends) or "sum" (MILP backends)."""
        self._objective = ell
        self._cost_form = form

    def set_terminal_cost(self, phi: Callable) -> None:
        self._terminal = phi

    def set_constraints(self, gs: Sequence[Callable]) -> None:
        """setConstraints parity (TrajectoryOptimizer.hpp:555-561):
        inequality callbacks g(x, u, t, data) <= 0. Obstacle/track
        avoidance needs no callback — it is built in from the VGP's
        exclusion zones."""
        self._path_ineq = list(gs)

    def add_eq_constraints(self, hs: Sequence[Callable]) -> None:
        self._path_eq = list(hs)

    def set_maximize(self, flag: bool) -> None:
        """setMaximize parity (TrajectoryOptimizer.hpp:375)."""
        self._maximize = bool(flag)

    def set_scheme(self, scheme: str) -> None:
        """Collocation scheme: euler (MILP difference-equation parity),
        trapezoidal, hermite_simpson."""
        self._scheme = scheme

    def set_solver_options(self, options: dict) -> dict:
        """Apply a reference-dialect option dict (PSOPT algorithm
        fields, IPOPT opt_settings, Dymos optimizer fields — see
        solve/options.py) to this optimizer's SolverConfig. Returns the
        translation hints, including any keys with no equivalent."""
        from .solve.options import nlp_config

        self.config, hints = nlp_config(options, self.config)
        if "scheme" in hints:
            self._scheme = hints["scheme"]
        if "nsteps" in hints and not self.vgp.nsteps:
            self.vgp.nsteps = hints["nsteps"]
        self._solver_hints = hints
        return hints

    def set_optimizer(self, name: str) -> None:
        """eDymos setOptimizer parity (eDymos.hpp:108): IPOPT/SNOPT
        requests are accepted — both collapse onto the native AL-SQP —
        and recorded for debug dumps."""
        self.set_solver_options({"optimizer": name})

    def set_planner(self, name: str) -> None:
        """eOMPL setPlanner parity (eOMPL.cpp:132): choose the sampling
        planner {RRT, SST, EST, KPIECE, PDST} used by :meth:`plan` —
        each keeps its defining mechanism (Voronoi bias, density bias,
        coverage bias, witness pruning, subdivision priorities;
        solve/planners.py); the extra non-OMPL names {CEM, SHOOTING} are
        also accepted. The name is validated here."""
        from .solve.planners import EXTRA_PLANNERS, PLANNERS

        if name.strip().upper() not in PLANNERS + EXTRA_PLANNERS:
            raise ValueError(
                f"unknown planner {name!r}; choose from "
                f"{PLANNERS + EXTRA_PLANNERS}"
            )
        self._planner = name.strip().upper()

    # ---- lifecycle ----------------------------------------------------
    def setup(self, pad: Optional[dict] = None) -> None:
        """Freeze the problem into (NLP, VGPData) on the facade's device.
        Parity: each backend's setup() transcription
        (eGurobi.cpp:79-111) — but done once, symbolically."""
        if self._dynamics is None:
            raise ValueError("set_dynamics() required before setup()")
        if self._objective is None:
            raise ValueError("set_objective() required before setup()")
        self.device = resolve(self.device)
        self.dims = self.vgp.dims(**(pad or {}))
        self.data, _ = self.vgp.to_device(
            self.dims, dtype=self.dtype, device=self.device)
        self.nlp = NLP(
            dims=self.dims,
            dynamics=self._dynamics,
            running_cost=self._objective,
            terminal_cost=self._terminal,
            path_ineq=tuple(self._path_ineq),
            path_eq=tuple(self._path_eq),
            scheme=self._scheme,
            cost_form=self._cost_form,
            use_obstacles=bool(self.vgp.obstacles or self.vgp.tracks),
            maximize=self._maximize,
            # XML <states rhorizon>/<controls rhorizon> as true history
            # windows (ePSOPT get_delayed_state/control parity,
            # ePSOPT.cpp:231-248): when > 0, the dynamics callback
            # receives [delay+1]-deep history slices instead of single
            # nodes — see transcribe.nlp.NLP.pair_defect
            x_delay=max(self.vgp.x_rhorizon, 0),
            u_delay=max(self.vgp.u_rhorizon, 0),
        )

    def _sync(self) -> None:
        """Wait for the device, so a host clock read after it times the
        work and not its dispatch."""
        if self.data.x0.device.type == "cuda":
            torch.cuda.synchronize(self.data.x0.device)

    def _solve_one(self, z0=None, lam0=None, rho0=None) -> SolveResult:
        """The unbatched solve, timed, its result kept as the scalar
        lifecycle's and as the next warm start."""
        t0 = time.perf_counter()
        self.result = al_sqp.solve(
            self.nlp, self.config, self.data, z0, lam0, rho0
        )
        with profiling.span("facade.sync"):
            self._sync()
        self._solve_time = time.perf_counter() - t0
        self._warm = _warm_state(self.result)
        return self.result

    def solve(self, warm: bool = False) -> SolveResult:
        """Run the solve. ``warm=True`` starts from the previous
        solution and multipliers (MPC re-solve, §3.1 of SURVEY.md)."""
        if self.nlp is None:
            raise ValueError("setup() must run before solve()")
        with profiling.span("facade.solve", warm=warm):
            if warm and self._warm is not None:
                return self._solve_one(*self._warm)
            return self._solve_one()

    def solve_exact(self, **kw):
        """Certified exact solve — the MILP-backend role (eGLPK/eGurobi
        ``solve()``, eGLPK.cpp:64-77): obstacle disjunctions AND any
        declared INTEGER/BINARY vartypes resolved by the unified
        branch-and-bound (:func:`etol_tpu_torch.solve.side_branch
        .solve_exact`; one tree, certificate-gated pruning, every wave of
        nodes one batched solve on the facade's device). Returns the
        :class:`~etol_tpu_torch.solve.branch_bound.MIPResult` (also
        stored as :attr:`mip_result`); the incumbent trajectory is
        installed as :attr:`result` so ``get_score``/``get_xtraj``/
        ``save`` work unchanged. Keyword arguments pass through
        (``wave``, ``max_nodes``, ``gap_tol``, ``convex_relaxation`` —
        by default bound pruning only when there are no user path
        inequalities of unknown curvature; pass True for linear user
        rows to enable pruning and a true gap)."""
        if self.nlp is None:
            raise ValueError("setup() must run before solve_exact()")
        from .solve import side_branch
        from .solve.branch_bound import integer_mask

        icols = integer_mask(self.vgp)
        t0 = time.perf_counter()
        mres = side_branch.solve_exact(
            self.nlp, self.config, self.data,
            int_cols=icols if icols.any() else None, **kw
        )
        self._solve_time = time.perf_counter() - t0
        self.mip_result = mres
        dev = self.data.x0.device
        lam_def, lam_eq, mu = (a[0] for a in al_sqp.init_multipliers(
            self.nlp, tree_map(lambda a: a[None], self.data)))

        def scalar(v, dtype=self.dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        # a failed search has no trajectory: infinite violations keep
        # get_score/save from presenting the all-zeros placeholder as a
        # feasible solve; a found incumbent was audited against the EXACT
        # constraint set inside the search (the smooth relaxation's
        # residuals mean nothing here)
        viol = 0.0 if mres.incumbent_found else float("inf")
        self.result = SolveResult(
            z=torch.as_tensor(mres.z, dtype=self.dtype, device=dev),
            obj=scalar(mres.obj),
            status=scalar(int(mres.status), torch.int32),
            outer_iters=scalar(mres.waves, torch.int32),
            inner_iters=scalar(mres.nodes_solved, torch.int32),
            viol_eq=scalar(viol),
            viol_in=scalar(viol),
            grad_norm=scalar(0.0),
            lam_def=lam_def, lam_eq=lam_eq, mu=mu,
            rho=scalar(self.config.rho0),
        )
        return mres

    def solve_batch(
        self,
        x0=None,
        xf=None,
        data: Optional[VGPData] = None,
        warm: bool = False,
        rescue: Optional[bool] = None,
        rescue_lanes: int = 0,
        rescue_cfg: Optional[SolverConfig] = None,
    ) -> SolveResult:
        """Solve a fleet of variants of this problem as one batch.

        Either pass a fully batched ``data`` (every leaf with a leading
        batch axis, e.g. from :func:`etol_tpu_torch.batch_tile`) — with
        ``x0``/``xf`` applied on top when also given — or pass
        ``x0``/``xf`` arrays (numpy or tensors) of shape [B, nx] and the
        current problem is tiled across them. Per-lane :class:`Status`
        rides in the result — a diverged lane never poisons the batch
        (SURVEY.md §5). With
        ``warm=True`` the previous batched solution warm-starts the fleet
        (eGurobi changeX0 at scale, eGurobi.cpp:419-432). ``rescue=True``
        (the default) gathers the ``rescue_lanes`` (default B//8) worst
        lanes after the main phase and re-solves them with
        shooting-seeded multistart
        (:func:`al_sqp.solve_batched_rescue`; as in the JAX package it
        always runs, and adopts nothing when every lane converged in
        phase 1). Default (``rescue=None``): rescue
        runs on COLD solves only; a warm fleet re-solve (the
        steady-state MPC tick) skips it, because paying a B//8-lane
        multistart on every tick is the wrong economics
        (eGurobi.cpp:419-432 exists precisely to make re-solves cheap).
        Pass an explicit True/False to override.

        The batched result is stored as :attr:`batch_result`;
        ``self.result`` (the scalar lifecycle: ``get_score``/
        ``get_xtraj``/``mpc_step``) is left untouched.
        """
        if self.nlp is None:
            raise ValueError("setup() must run before solve_batch()")
        with profiling.span("facade.solve_batch"):
            with profiling.span("facade.prepare"):
                data, z0, lam0, rho0 = self._batch_inputs(x0, xf, data,
                                                          warm)
            if rescue is None:
                rescue = z0 is None  # cold solves rescue; warm ticks skip
            t0 = time.perf_counter()
            if rescue:
                res = al_sqp.solve_batched_rescue(
                    self.nlp, self.config, data,
                    rescue_lanes=rescue_lanes, rescue_cfg=rescue_cfg,
                    z0=z0, lam0=lam0, rho0=rho0,
                )
            else:
                res = al_sqp.solve_batched(
                    self.nlp, self.config, data, z0, lam0, rho0
                )
            with profiling.span("facade.sync"):
                self._sync()
            self._solve_time = time.perf_counter() - t0
        self._warm_batch = _warm_state(res)
        self.batch_result = res
        return res

    def _batch_inputs(self, x0, xf, data, warm):
        """:meth:`solve_batch`'s data on the device and its warm start
        (z0, lam0, rho0; None for a cold start)."""
        if data is None:
            if x0 is None and xf is None:
                raise ValueError("solve_batch needs x0/xf arrays or data")
            B = int((x0 if x0 is not None else xf).shape[0])
            data = batch_tile(self.data, B)
        if x0 is not None:
            data = dataclasses.replace(data, x0=self._tensor(x0))
        if xf is not None:
            data = dataclasses.replace(data, xf=self._tensor(xf))
        B = int(data.x0.shape[0])
        z0 = lam0 = rho0 = None
        if warm and getattr(self, "_warm_batch", None) is not None:
            z0, lam0, rho0 = self._warm_batch
            if int(z0.shape[0]) != B:
                import warnings

                warnings.warn(
                    f"solve_batch(warm=True): previous batch size "
                    f"{int(z0.shape[0])} != {B}; falling back to cold start"
                )
                z0 = lam0 = rho0 = None
        return data, z0, lam0, rho0

    def _tensor(self, a) -> torch.Tensor:
        """A host sequence, numpy array or tensor on the facade's device
        in its dtype."""
        return torch.as_tensor(
            np.array(a) if not isinstance(a, torch.Tensor) else a,
            dtype=self.dtype, device=self.data.x0.device)

    @staticmethod
    def _floats(a) -> list:
        """Host floats of a sequence or tensor, for the host-side VGP."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().tolist()
        return [float(v) for v in a]

    def plan(
        self,
        n_samples: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        solve_time: Optional[float] = None,
        **kw,
    ) -> SolveResult:
        """Sampling-based solve — the eOMPL backend's role
        (eOMPL.cpp:161-173): run the planner chosen by
        :meth:`set_planner` (default SHOOTING, the strongest NLP seed),
        pack the best rollout as a result. Status is SOLVED when the
        rollout reaches the goal band collision-free, MAX_ITER otherwise
        (the planner's "approximate solution" outcome).

        ``solve_time`` is the reference's solve-budget dial: eOMPL runs
        its planner for ``nSteps * dt`` wall-clock seconds
        (eOMPL.cpp:241, consumed at :164). When neither ``n_samples``
        nor ``solve_time`` is given, the problem-derived default budget
        ``nsteps * dt`` seconds applies, mapped deterministically onto
        a sample count (:func:`etol_tpu_torch.solve.planners
        .budget_samples`); a shorter budget grows a smaller search and
        yields the approximate-solution status. The draws come from
        ``generator`` (seed 0 on the facade's device when none is
        given)."""
        if self.nlp is None:
            raise ValueError("setup() must run before plan()")
        from .solve import planners

        if n_samples is None and solve_time is None:
            # the reference's problem-derived default (eOMPL.cpp:241)
            solve_time = self.dims.nsteps * float(self.vgp.dt)
        t0 = time.perf_counter()
        X, U, info = planners.plan(
            getattr(self, "_planner", "SHOOTING"),
            self.nlp.dynamics,
            self.dims.nsteps,
            self.data,
            n_samples,
            generator,
            solve_time=solve_time,
            **kw,
        )
        z = self.nlp.pack(X, U)
        self._sync()
        self._solve_time = time.perf_counter() - t0
        at_goal = bool(
            torch.all(torch.abs(X[-1] - self.data.xf) <= self.data.xtol)
        )
        g = self.nlp.node_ineqs(z, self.data)
        viol_in = al_sqp._amax0(torch.clamp(g, min=0.0))
        # same feasibility tolerance as the solver's KKT test (the
        # status must mean the same thing across solve() and plan())
        collision_free = bool(viol_in <= self.config.tol_cons)
        zero = z.new_zeros(())
        izero = torch.zeros((), dtype=torch.int32, device=z.device)
        lam_def, lam_eq, mu = (a[0] for a in al_sqp.init_multipliers(
            self.nlp, tree_map(lambda a: a[None], self.data)))
        self.result = SolveResult(
            z=z,
            obj=self.nlp.score(z, self.data),
            status=izero + int(
                Status.SOLVED if at_goal and collision_free
                else Status.MAX_ITER),
            outer_iters=izero,
            inner_iters=izero,
            viol_eq=zero,
            viol_in=viol_in,
            grad_norm=zero,
            lam_def=lam_def, lam_eq=lam_eq, mu=mu,
            rho=zero + self.config.rho0,
        )
        return self.result

    def debug(self) -> str:
        """Transcription summary dump — the analog of the backends'
        debug() LP-file writes (eGLPK.cpp:258, eGurobi.cpp:127)."""
        d = self.dims
        lines = [
            "etol-tpu-torch transcription",
            f"  nodes={d.nodes} nx={d.nx} nu={d.nu} nz={d.nz}",
            f"  scheme={self._scheme} cost={self._cost_form}",
            f"  ellipses={d.max_ellipses} pieces={d.max_pieces} "
            f"tracks={d.max_tracks}",
            f"  dtype={str(self.dtype).replace('torch.', '')} "
            f"device={self.device}",
        ]
        if self.result is not None:
            r = self.result
            lines.append(
                f"  status={Status(int(r.status)).name} "
                f"obj={float(r.obj):.6f} viol={float(r.viol_eq):.2e}/"
                f"{float(r.viol_in):.2e} iters={int(r.outer_iters)}/"
                f"{int(r.inner_iters)}"
            )
        out = "\n".join(lines)
        print(out)
        return out

    def close(self) -> None:
        """Release references (close() parity, eSCIP.cpp:78-92 — here
        the tensors are collected, nothing manual to free)."""
        self.result = None
        self._warm = None
        self.batch_result = None
        self._warm_batch = None

    # ---- results (reference getter parity) ----------------------------
    def get_score(self) -> float:
        """getScore (TrajectoryOptimizer.cpp:1655-1661)."""
        return float(self.result.obj)

    def get_status(self) -> Status:
        return Status(int(self.result.status))

    def _times(self):
        return np.arange(self.dims.nodes) * float(self.vgp.dt)

    def get_xtraj(self):
        """getXtraj (TrajectoryOptimizer.cpp:1819-1825): (times [K],
        states [K, nx])."""
        X, _ = self.nlp.unpack(self.result.z)
        return self._tensor(self._times()), X

    def get_utraj(self):
        _, U = self.nlp.unpack(self.result.z)
        return self._tensor(self._times()), U

    def save(self, traj, fp: str) -> str:
        """CSV export (save, TrajectoryOptimizer.cpp:626-674)."""
        return trajectory.save(traj, fp)

    # ---- MPC fast path (changeX0/changeXf parity) ---------------------
    def set_x0(self, x0: Sequence[float]) -> None:
        """Swap the initial state (the eGurobi x0_changed_ fast path,
        eGurobi.cpp:419-432,479-494). ``x0`` is a host sequence or a
        tensor; it lands on the facade's device."""
        self.vgp.x0 = self._floats(x0)
        self.data = dataclasses.replace(self.data, x0=self._tensor(x0))

    def set_xf(self, xf: Sequence[float]) -> None:
        """changeXf parity (eGurobi.cpp:434-453,496-511)."""
        self.vgp.xf = self._floats(xf)
        self.data = dataclasses.replace(self.data, xf=self._tensor(xf))

    def mpc_step(
        self, x0_new: Sequence[float], advance_time: bool = True
    ) -> SolveResult:
        """One receding-horizon re-solve: new x0, warm start from the
        previous solution shifted one step forward in time.

        ``advance_time`` shifts the moving-obstacle waypoint schedules by
        -dt so the re-solve's t=0 is "now" (the reference leaves track
        realignment to the caller; here it is the default because the
        shifted warm start only makes sense on the shifted clock)."""
        if self.result is None:
            raise ValueError("solve() once before mpc_step()")
        with profiling.span("facade.mpc_step"):
            with profiling.span("facade.prepare"):
                self.set_x0(x0_new)
                if advance_time and self.dims.max_tracks > 0:
                    trk = self.data.tracks
                    self.data = dataclasses.replace(
                        self.data,
                        tracks=dataclasses.replace(
                            trk, times=trk.times - float(self.vgp.dt)),
                    )
                z, lam, rho = _warm_state(self.result)
                Z = z.reshape(self.dims.nodes, -1)
                Zs = torch.cat([Z[1:], Z[-1:]], dim=0)  # shift, hold last
            return self._solve_one(Zs.reshape(-1), lam, rho)

    @property
    def last_solve_seconds(self) -> float:
        return self._solve_time
