"""Wave backend: host-orchestrated branch-and-bound over batched device LPs.

The port of ``moip_aira_tpu/solver/wave.py`` for its per-LP configuration
(``fragments=False``).  The LP relaxations run on the device — K1, the CUDA
dense-tableau kernel, or K2, the CUDA revised-simplex kernel, chosen by the
LP's shape (solver/cuda_lp.py) on a GPU; their plain PyTorch versions
(solver/simplex_torch.py) on the CPU — and the branch-and-bound tree search
runs on the host:

  wave loop:  gather up to ``batch_width`` open nodes across every active
              (worker, lex-stage) task  →  one asynchronous device call
              solves all their LP relaxations (float32)  →  certify every
              result exactly in float64 from the returned bases
              (solver/verify.py)  →  prune / bound / branch on the host  →
              repeat, with up to two waves in flight so host work hides
              device time.

Because nodes from every AIRA worker, every EPP strip and every
lexicographic stage share one batch, the device stays full even though each
B&B tree is sequential.  Host-side MIP machinery: previous-stage warm
incumbents, rounding + 1-swap local search (solver/heuristics.py),
reduced-cost fixing from the exact certificate duals, and optional
parent-basis warm starts for the device LPs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver.lex import LexOutcome, LexRequest, NumpyLexBackend
from moip_aira_tpu_torch.solver.status import SolveStatus
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.device import resolve_device
from moip_aira_tpu_torch.solver import simplex_torch as sx
from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch, make_cuda_rev_batch
from moip_aira_tpu_torch.solver.verify import LPVerifier

INT_TOL = 1e-6
#: the reference's shape threshold between its dense and revised kernels
#: (moip_aira_tpu/solver/wave.py:178-181): LPs of at least this many
#: columns n + m take the revised simplex
REVISED_MIN_COLUMNS = 512
#: pivot caps per LP by engine.  The reference's 2000 bounded a TPU loop
#: that ran a chunk of lanes in lock step to the cap; on the card each lane
#: stops on its own, so a higher cap costs only the lanes that need it.
#: K2's f32 pivots on 2AP40's degenerate assignment LPs pass 2000 often:
#: at 2000 the front re-solved 333 of its 2,598 LPs on the host, at 6000
#: 43 of 2,596 (PERF.md)
MAX_ITERS = {"dense": 2000, "revised": 6000}
ENGINES = ("auto", "dense", "revised")


class _StageTask:
    """One single-objective MIP (one lexicographic stage of one request)."""

    __slots__ = (
        "req_idx",
        "stage",
        "obj_j",
        "c_struct",
        "obj_int",
        "srhs",
        "nodes",
        "best",
        "best_x",
        "node_count",
        "failed",
        "cvec",
        "llo",
        "lhi",
        "ls_budget",
        "fix_d",
        "inflight",
    )

    def __init__(self, req_idx, stage, obj_j, c_struct, obj_int, srhs, lb, ub):
        self.req_idx = req_idx
        self.stage = stage
        self.obj_j = obj_j
        self.c_struct = c_struct
        self.obj_int = obj_int
        self.srhs = srhs
        # DFS stack of (lo, hi, warm_basis, warm_at_upper, parent_bound,
        # retry); parent_bound is a valid f64 lower bound on every solution
        # in the node (its parent's certified LP bound) — checked against
        # the incumbent at SUBMIT time, so nodes created before a better
        # incumbent arrived are dropped without a device solve.
        self.nodes: List = [(lb.copy(), ub.copy(), None, None, -np.inf, 0)]
        self.best = np.inf
        self.best_x: Optional[np.ndarray] = None
        self.node_count = 0
        self.failed = False
        self.cvec = None  # (nc,) objective vector incl. logical zeros
        self.llo = None  # logical lower bounds for this stage's srhs
        self.lhi = None
        self.ls_budget = 4  # local-search polish calls for this MIP
        self.fix_d = True  # reduced-cost fixing enabled
        self.inflight = 0  # nodes currently inside an unprocessed wave


class WaveLexBackend:
    """Exact lexicographic CLMOIP solves via device LP waves.

    ``engine`` picks the LP kernel as the reference picks its Pallas
    kernels: ``"dense"`` is K1 (the reference's ``"pallas"``),
    ``"revised"`` is K2 (``"pallas_rev"``), and ``"auto"`` takes
    ``"revised"`` when the LP has n + m >= REVISED_MIN_COLUMNS columns.
    ``lp_max_iters`` caps the pivots of one LP (default: the engine's
    MAX_ITERS).
    ``device`` is where the LP relaxations run: the kernel's wrapper
    (solver/cuda_lp.py) launches it on a CUDA device and runs its plain
    version on the CPU.  ``fragments`` must be False: the whole-subtree
    fragment path (K3) is not ported yet."""

    name = "wave"
    #: adaptive drivers may stream requests in via lex_solve_batch(feeder=)
    supports_feeder = True

    def __init__(
        self,
        problem: Problem,
        batch_width: int = 256,
        nodes_per_task: int = 8,
        lp_max_iters: Optional[int] = None,
        max_nodes: int = 500000,
        device="cuda",
        warm_start="auto",
        fragments=False,
        engine="auto",
    ):
        if fragments is not False:
            raise NotImplementedError(
                "fragments: the B&B fragment path and its kernel K3 "
                "(pallas_bb.make_pallas_bb_batch) are not ported yet; see "
                "ROADMAP.md, queue 2, K3"
            )
        self.problem = problem
        self.batch_width = batch_width
        self.nodes_per_task = nodes_per_task
        self.max_nodes = max_nodes
        self.device = resolve_device(device)
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        p = problem
        self.k = p.objcnt
        self.n = p.n
        self.m = p.m_total
        if engine == "auto":
            wide = self.n + self.m >= REVISED_MIN_COLUMNS
            engine = "revised" if wide else "dense"
        self.engine = engine
        # Warm-starting children from parent bases (the kernels' Gauss-Jordan
        # rebuild) pays on the revised simplex, whose rebuild works on the
        # (m, m) basis block, and not on the dense tableau, where each
        # rebuild step costs about two pivots over the whole tableau and m
        # of them exceed a cold solve's ~2-4m pivots.  'auto' turns it on
        # for the revised engine only, as the reference does.
        if warm_start == "auto":
            self.warm_start = engine == "revised"
        else:
            self.warm_start = bool(warm_start)
        self._wave_basis = None
        self._wave_atup = None

        self.is_min = p.objsen is Sense.MIN
        # row equilibration: the device sees [diag(s)A | -I] with logical
        # bounds scaled by s at submit; basis indices, at-upper flags and
        # structural x are scale-invariant, and every claim is certified
        # against the UNSCALED data (convert.py)
        lpt = lp_tensors(p, self.device)
        self._A_full = lpt.A_full
        self._row_scale = lpt.row_scale
        make_kernel = make_cuda_rev_batch if engine == "revised" else make_cuda_lp_batch
        if lp_max_iters is None:
            lp_max_iters = MAX_ITERS[engine]
        self.lp_kernel = make_kernel(lpt.W_dev, self.device, max_iters=lp_max_iters)
        self._verifier = LPVerifier(lpt.W_np)
        self._ws = None  # lazy SimplexWorkspace for the exact host LPs
        self.verify_fallbacks = 0
        self.int_idx = np.flatnonzero(p.is_int)
        self.obj_integral = np.array(
            [
                bool(
                    np.all(p.C[j] == np.rint(p.C[j]))
                    and np.all(p.is_int[np.abs(p.C[j]) > 0])
                )
                for j in range(p.objcnt)
            ]
        )
        self.device_waves = 0
        self.lp_count = 0
        self._fallback = NumpyLexBackend(problem)
        #: counts of the rarer host events (req_fallbacks), under the
        #: reference's name
        self.frag_stats = {}

    # -- stage plumbing ----------------------------------------------------
    def _assign_struct(self, glo, ghi):
        """Cached assignment-structure detection (heuristics.detect_assignment).

        The equality structure lives in the STRUCTURAL rows (identical for
        every stage task — objective-bound rows are always inequalities),
        so one detection serves the whole solve."""
        if not hasattr(self, "_assign_struct_cache"):
            from moip_aira_tpu_torch.solver.heuristics import detect_assignment

            self._assign_struct_cache = detect_assignment(
                self._A_full, glo, ghi
            )
        return self._assign_struct_cache

    def _stage_task(self, req_idx, stage, perm, srhs, x_warm=None) -> _StageTask:
        j = perm[stage]
        sign = 1.0 if self.is_min else -1.0
        t = _StageTask(
            req_idx,
            stage,
            j,
            sign * self.problem.C[j],
            self.obj_integral[j],
            srhs,
            self.problem.lb,
            self.problem.ub,
        )
        t.cvec = np.concatenate([t.c_struct, np.zeros(self.m)])
        t.llo, t.lhi = self._logical_bounds(srhs)
        if x_warm is not None:
            # the previous stage's optimum is feasible here (its objective
            # bound was fixed at the achieved value) -> warm incumbent.
            # A sweep-chain hint (LexRequest.x_hint) violates the NEW
            # objective bound by one front step — repair it first: unit
            # moves/swaps for inequality structures, 2x2 cycle moves for
            # the assignment family (where any single swap breaks two
            # equality rows).
            from moip_aira_tpu_torch.solver.heuristics import (
                candidate_value, cycle_improve, repair,
            )

            glo = np.concatenate([self.problem.lb, t.llo])
            ghi = np.concatenate([self.problem.ub, t.lhi])
            struct = self._assign_struct(glo, ghi)
            v = candidate_value(self._A_full, t.c_struct, glo, ghi, x_warm)
            if v is None and self.int_idx.size:
                xr = None
                if struct is not None:
                    xr = cycle_improve(
                        self._A_full, t.c_struct, glo, ghi,
                        np.asarray(x_warm, dtype=np.float64), struct,
                    )
                if xr is None:
                    xr = repair(
                        self._A_full, t.c_struct, glo, ghi,
                        np.asarray(x_warm, dtype=np.float64), self.int_idx,
                    )
                if xr is not None:
                    x_warm = xr
                    v = candidate_value(
                        self._A_full, t.c_struct, glo, ghi, x_warm
                    )
            if v is not None:
                t.best = v
                t.best_x = np.asarray(x_warm, dtype=np.float64).copy()
        return t

    def _logical_bounds(self, srhs):
        p = self.problem
        if self.is_min:
            olo, ohi = np.full(self.k, -INF), srhs
        else:
            olo, ohi = srhs, np.full(self.k, INF)
        lo = np.concatenate([p.row_lb, olo])
        hi = np.concatenate([p.row_ub, ohi])
        return lo, hi

    def _certify_wave(self, c, lo, hi, status, basis, at_upper):
        """Certify f32 device claims in f64; uncertified lanes continue the
        exact host simplex *warm-started from the device basis*.

        Soundness model (see verify.py): pruning uses ONLY
        ``self._dual_lb`` — the rigorous interval dual bound where the
        certificate held, the exact host LP value where it did not.  The
        claimed vertex value ``objv`` guides heuristics and branching but
        never a prune."""
        cert = self._verifier.certify(c, lo, hi, status, basis, at_upper)
        objv = np.where(cert.ok, cert.obj, np.nan)
        xs = cert.x
        self._last_cert = cert
        # duals are only valid where the certificate held AND the device
        # claimed OPTIMAL (verify.py contract); uncertified lanes keep
        # *stale* cert rows — reduced-cost fixing on those is unsound
        self._cert_fix_ok = cert.ok & (status == sx.OPTIMAL)
        self._dual_lb = cert.dual_bound.copy()
        self._lane_exact = np.zeros(len(status), dtype=bool)
        # every uncertified or iteration-limited lane — and any certified
        # lane whose rigorous bound came out -inf — is re-solved exactly
        # NOW, warm-started from the device basis, all in ONE batched
        # lockstep f64 simplex call (solver/simplex_batch.py)
        retry = np.flatnonzero(
            ~cert.ok
            | ((status != sx.OPTIMAL) & (status != sx.INFEASIBLE))
            | ((status == sx.OPTIMAL) & ~np.isfinite(cert.dual_bound))
        )
        if retry.size:
            rs = self._host_exact_lp_batch(
                c[retry][:, : self.n], lo[retry], hi[retry],
                basis[retry], at_upper[retry],
            )
            for k_, i in enumerate(retry):
                r = rs[k_]
                self._lane_exact[i] = True
                self._cert_fix_ok[i] = False
                if r.status == SolveStatus.OPTIMAL:
                    status[i] = sx.OPTIMAL
                    objv[i] = r.obj
                    xs[i] = r.x
                    self._dual_lb[i] = r.obj
                elif r.status == SolveStatus.INFEASIBLE:
                    status[i] = sx.INFEASIBLE
                    objv[i] = np.nan
                    self._dual_lb[i] = np.inf
                else:
                    status[i] = sx.ITER_LIMIT
        return status, objv, xs

    def _workspace(self):
        if self._ws is None:
            from moip_aira_tpu_torch.solver.simplex_np import SimplexWorkspace

            self._ws = SimplexWorkspace(self._A_full)
        return self._ws

    def _host_exact_lp(self, c_struct, lo, hi, warm_basis, warm_at_upper):
        """One exact f64 LP on the host, warm-started from a device basis."""
        from moip_aira_tpu_torch.solver.simplex_np import solve_lp
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        ws = self._workspace()
        self.verify_fallbacks += 1
        with GLOBAL_TIMINGS.span("host.exact_lp"):
            return solve_lp(
                ws, c_struct, lo, hi,
                warm_basis=warm_basis, warm_at_upper=warm_at_upper,
            )

    def _host_exact_lp_batch(self, cS, loS, hiS, wbS=None, waS=None):
        """Batched exact f64 LPs — all of a wave's failed lanes in one
        lockstep vectorised call (solver/simplex_batch.py)."""
        from moip_aira_tpu_torch.solver.simplex_batch import solve_lp_batch
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        ws = self._workspace()
        self.verify_fallbacks += len(cS)
        with GLOBAL_TIMINGS.span("host.exact_lp"):
            return solve_lp_batch(
                ws, np.asarray(cS, dtype=np.float64),
                np.asarray(loS, dtype=np.float64),
                np.asarray(hiS, dtype=np.float64),
                warm_basis=wbS, warm_at_upper=waS,
            )

    # -- wave submit / complete --------------------------------------------
    def _device_lp(self, c, lo, hi, wb, wa):
        """Start the device LPs of one wave; returns the host buffers that
        will hold (status, basis, at_upper) and the event that says they
        are filled (None on the CPU, where the call is synchronous).

        On a GPU nothing here waits for the card: inputs go up, the kernel is
        queued and the three outputs the host reads come back by asynchronous
        copies into pinned buffers, so a second wave can be queued behind
        this one while the host works on an earlier one.  The logical bounds
        are row-scaled here, as the device system is."""
        dev = self.device
        lo = lo.copy()
        hi = hi.copy()
        lo[:, self.n :] *= self._row_scale
        hi[:, self.n :] *= self._row_scale

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(
                dev, non_blocking=True
            )

        out = self.lp_kernel(
            up(c, np.float32), up(lo, np.float32), up(hi, np.float32),
            up(wb, np.int32), up(wa, np.int32),
        )
        if dev.type != "cuda":
            return out.status, out.basis, out.at_upper, None
        host = []
        for t in (out.status, out.basis, out.at_upper):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return (*host, done)

    def _submit_wave(self, active: List[_StageTask]):
        """Gather open nodes from ``active`` and start an async device call.

        Returns (wave, nb, c, lo, hi, device_out) or None if nothing is
        pending.  The device call is NOT waited on — the caller can overlap
        host work (completing another pool's wave) with this one's device
        time.  Only the ``nb`` gathered lanes are launched: the reference's
        trivial-LP padding up to ``batch_width`` only filled its fixed-size
        TPU batch.
        """
        B = self.batch_width
        nc = self.n + self.m
        wave: List = []  # (task, node_lo, node_hi, warm_basis, warm_atup, pb, rt)
        if self.warm_start:
            # homogeneous waves: cold roots and warm children are gathered
            # separately, preferring the more numerous kind
            warm_n = cold_n = 0
            for t_ in active:
                if t_.nodes:
                    if t_.nodes[-1][2] is None:
                        cold_n += len(t_.nodes)
                    else:
                        warm_n += len(t_.nodes)
            want_warm = warm_n >= cold_n

            def want(node):
                return (node[2] is not None) == want_warm

        else:

            def want(node):
                return True

        # adaptive quota: when few tasks are active, let every task claim an
        # equal share of the whole batch; nodes_per_task stays the floor so
        # many-task phases keep their fair round-robin
        n_active = sum(1 for t_ in active if t_.nodes)
        quota = max(self.nodes_per_task, B // max(1, n_active))
        for task in active:
            take = 0
            eps_t = INT_TOL if task.obj_int else 1e-9
            while (
                take < quota
                and task.nodes
                and len(wave) < B
                and want(task.nodes[-1])
            ):
                node = task.nodes.pop()
                if node[4] >= task.best - eps_t:
                    continue  # incumbent improved since this node was made
                wave.append((task, *node))
                take += 1
            task.inflight += take
            if len(wave) >= B:
                break
        nb = len(wave)
        if nb == 0 and self.warm_start:
            # nothing of the preferred kind at the stack tops — take anything
            for task in active:
                take = 0
                eps_t = INT_TOL if task.obj_int else 1e-9
                while take < quota and task.nodes and len(wave) < B:
                    node = task.nodes.pop()
                    if node[4] >= task.best - eps_t:
                        continue
                    wave.append((task, *node))
                    take += 1
                task.inflight += take
                if len(wave) >= B:
                    break
            nb = len(wave)
        if nb == 0:
            return None
        c_buf = np.zeros((nb, nc))
        lo_buf = np.zeros((nb, nc))
        hi_buf = np.zeros((nb, nc))
        wb_buf = np.full((nb, self.m), -1, dtype=np.int32)
        wa_buf = np.zeros((nb, nc), dtype=np.int32)
        for i, (task, nlo, nhi, wb, wa, _pb, _rt) in enumerate(wave):
            c_buf[i] = task.cvec
            lo_buf[i, : self.n] = nlo
            lo_buf[i, self.n :] = task.llo
            hi_buf[i, : self.n] = nhi
            hi_buf[i, self.n :] = task.lhi
            if wb is not None:
                wb_buf[i] = wb
                wa_buf[i] = wa
        out = self._device_lp(c_buf, lo_buf, hi_buf, wb_buf, wa_buf)
        return wave, nb, c_buf, lo_buf, hi_buf, out

    def _complete_wave(self, submitted, state) -> None:
        """Fetch, certify and branch-process one in-flight wave."""
        wave, nb, c_buf, lo_buf, hi_buf, out = submitted
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        status_t, basis_t, atup_t, done = out
        with GLOBAL_TIMINGS.span("wave.device_lp"):
            if done is not None:
                done.synchronize()
            status = status_t.numpy().copy()
            basis_h = basis_t.numpy().copy()
            atup_h = atup_t.numpy().copy()
        self._wave_basis = basis_h
        self._wave_atup = atup_h
        self.device_waves += 1
        self.lp_count += nb

        with GLOBAL_TIMINGS.span("wave.certify"):
            status, objv, xs = self._certify_wave(
                c_buf, lo_buf, hi_buf, status, basis_h, atup_h
            )

        # ---- process on host (branch decisions vectorised) ----------
        obj_int_arr = np.fromiter(
            (w[0].obj_int for w in wave), dtype=bool, count=nb
        )
        # node lower bounds: the rigorous interval dual bound for certified
        # lanes, the exact host LP value otherwise (verify.py soundness
        # model — the claimed vertex value objv is NEVER used to prune)
        lane_lb = self._dual_lb[:nb]
        lane_exact = self._lane_exact[:nb]
        bounds = np.where(obj_int_arr, np.ceil(lane_lb - INT_TOL), lane_lb)
        if self.int_idx.size:
            xi = xs[:nb][:, self.int_idx]
            frs = np.abs(xi - np.rint(xi))
            jmaxs = np.argmax(frs, axis=1)
            lanes = np.arange(nb)
            frmaxs = frs[lanes, jmaxs]
            jlocs = self.int_idx[jmaxs]
            fls = np.floor(xs[:nb][lanes, jlocs] + INT_TOL)
            # batched rounding heuristic: ONE feasibility GEMM for every
            # lane's rounded-and-clipped LP point
            cands = xs[:nb].copy()
            r_lo = np.stack([w[1] for w in wave])
            r_hi = np.stack([w[2] for w in wave])
            ii = self.int_idx
            cands[:, ii] = np.clip(np.rint(cands[:, ii]), r_lo[:, ii], r_hi[:, ii])
            acts = cands @ self._A_full.T  # (nb, m)
            glo_l = np.stack([w[0].llo for w in wave])
            ghi_l = np.stack([w[0].lhi for w in wave])
            htol = 1e-7
            cand_ok = (
                (cands >= self.problem.lb[None, :] - htol)
                & (cands <= self.problem.ub[None, :] + htol)
            ).all(axis=1) & (
                (acts >= glo_l - htol) & (acts <= ghi_l + htol)
            ).all(axis=1)
            c_structs = np.stack([w[0].c_struct for w in wave])
            cand_vals = np.where(
                cand_ok, np.einsum("ln,ln->l", cands, c_structs), np.inf
            )
        else:
            frmaxs = np.zeros(nb)
            jlocs = np.zeros(nb, dtype=np.int64)
            fls = np.zeros(nb)
            cand_ok = np.zeros(nb, dtype=bool)
            cand_vals = np.full(nb, np.inf)
        for i, (task, nlo, nhi, _wb, _wa, _pb, _rt) in enumerate(wave):
            task.node_count += 1
            task.inflight -= 1
            if task.failed:
                continue
            st = int(status[i])
            if st == sx.INFEASIBLE:
                continue
            if st != sx.OPTIMAL or task.node_count > self.max_nodes:
                # resource trouble — resolve this whole request on host
                task.failed = True
                task.nodes.clear()
                continue
            eps_i = INT_TOL if task.obj_int else 1e-9
            if bounds[i] >= task.best - eps_i:
                continue
            if frmaxs[i] <= INT_TOL:
                # integral leaf.  For certified (non-exact) lanes the value
                # objv is the claimed vertex's — validate the rounded
                # candidate exactly in f64 before adopting, and close the
                # node only if its rigorous bound proves no strictly better
                # point exists in it; otherwise fall through to an exact
                # host re-solve of the lane.
                if lane_exact[i]:
                    if objv[i] < task.best - INT_TOL:
                        task.best = objv[i]
                        task.best_x = xs[i].copy()
                    continue
                if cand_ok[i]:
                    v = cand_vals[i]
                    if v < task.best - INT_TOL:
                        task.best = v
                        task.best_x = cands[i].copy()
                    if bounds[i] >= v - eps_i:
                        continue  # node closed: nothing in it beats v
                r = self._host_exact_lp(
                    c_buf[i, : self.n], lo_buf[i], hi_buf[i],
                    self._wave_basis[i], self._wave_atup[i],
                )
                self._cert_fix_ok[i] = False
                if r.status == SolveStatus.INFEASIBLE:
                    continue
                if r.status != SolveStatus.OPTIMAL:
                    task.failed = True
                    task.nodes.clear()
                    continue
                objv[i] = r.obj
                xs[i] = r.x
                bounds[i] = np.ceil(r.obj - INT_TOL) if task.obj_int else r.obj
                if bounds[i] >= task.best - eps_i:
                    continue
                if self.int_idx.size:
                    xi_i = r.x[self.int_idx]
                    fr_i = np.abs(xi_i - np.rint(xi_i))
                    jm = int(np.argmax(fr_i))
                    frmaxs[i] = fr_i[jm]
                    jlocs[i] = self.int_idx[jm]
                    fls[i] = np.floor(r.x[jlocs[i]] + INT_TOL)
                if frmaxs[i] <= INT_TOL:
                    # exact LP optimum is integral: node optimum found
                    if objv[i] < task.best - INT_TOL:
                        task.best = objv[i]
                        task.best_x = xs[i].copy()
                    continue
                # else: fall through and branch on the exact solution

            # rounding + local-search heuristic (budgeted per MIP): the
            # rounded candidate is adopted whenever it improves the
            # incumbent; the 1-swap polish runs only when that happened
            if cand_ok[i] and self.int_idx.size:
                v = cand_vals[i]
                if v < task.best - INT_TOL:
                    task.best = v
                    task.best_x = cands[i].copy()
                    if task.ls_budget > 0:
                        from moip_aira_tpu_torch.solver.heuristics import local_search

                        task.ls_budget -= 1
                        glo = np.concatenate([self.problem.lb, task.llo])
                        ghi = np.concatenate([self.problem.ub, task.lhi])
                        cand, v = local_search(
                            self._A_full, task.c_struct, glo, ghi,
                            cands[i].copy(), self.int_idx,
                        )
                        if v < task.best - INT_TOL:
                            task.best = v
                            task.best_x = cand.copy()
                    if bounds[i] >= task.best - eps_i:
                        continue

            # reduced-cost fixing — rigorous version (verify.py model):
            # with y the certificate's dual vector, ANY feasible z with
            # integer z_j moved off its bound by >= 1 has
            #   c.z >= dual_lb + max(0, d_j -+ E_j)
            # so the fix is sound iff dual_lb + gain clears the cutoff.
            # Only where _cert_fix_ok (dual_lb and d come from the SAME y).
            child_lo = nlo
            child_hi = nhi
            cert = self._last_cert
            if (
                task.fix_d
                and self._cert_fix_ok[i]
                and np.isfinite(task.best)
                and np.isfinite(lane_lb[i])
            ):
                margin = (
                    task.best
                    - (1.0 if task.obj_int else 0.0)
                    - lane_lb[i]
                    + INT_TOL
                )
                if np.isfinite(margin):
                    dx = cert.d[i][self.int_idx]
                    ex = cert.d_err[i][self.int_idx]
                    nbm = ~cert.in_basis[i][self.int_idx]
                    upm = cert.at_upper[i][self.int_idx]
                    f_lo = nbm & ~upm & (dx - ex > margin)
                    f_hi = nbm & upm & (-dx - ex > margin)
                    if f_lo.any() or f_hi.any():
                        child_lo = nlo.copy()
                        child_hi = nhi.copy()
                        ids_lo = self.int_idx[f_lo]
                        ids_hi = self.int_idx[f_hi]
                        child_hi[ids_lo] = nlo[ids_lo]
                        child_lo[ids_hi] = nhi[ids_hi]

            jloc = int(jlocs[i])
            fl = fls[i]
            up_lo = child_lo.copy()
            up_lo[jloc] = fl + 1
            dn_hi = child_hi.copy()
            dn_hi[jloc] = fl
            # children warm-start from this node's optimal basis
            cb = self._wave_basis[i] if self.warm_start else None
            ca = self._wave_atup[i] if self.warm_start else None
            # DFS toward the LP value: nearer child on top; children inherit
            # this node's certified bound for submit-time pruning
            pb = float(bounds[i])
            if xs[i][jloc] - fl > 0.5:
                task.nodes.append((child_lo, dn_hi, cb, ca, pb, 0))
                task.nodes.append((up_lo, child_hi, cb, ca, pb, 0))
            else:
                task.nodes.append((up_lo, child_hi, cb, ca, pb, 0))
                task.nodes.append((child_lo, dn_hi, cb, ca, pb, 0))

    def _advance_pool(
        self, pool: List[_StageTask], state, feeder=None
    ) -> List[_StageTask]:
        """Finish tasks whose stacks drained; start their next stages.

        ``feeder(req_idx, outcome) -> List[LexRequest]`` streams NEW
        requests in as others complete (no batch barrier): the returned
        requests join the pool immediately, so adaptive drivers (the bound
        sweep) keep the device saturated instead of idling on stragglers.
        """
        reqs, results, ips, infeasible, srhs_by_req, perms, xwarm_by_req = state
        import os as _os

        audit = _os.environ.get("MOIP_WAVE_LOG")
        still: List[_StageTask] = []

        def _request_done(ri: int) -> None:
            if feeder is None:
                return
            if infeasible[ri]:
                out = LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[ri]))
            else:
                out = LexOutcome(
                    SolveStatus.OPTIMAL, results[ri].copy(), int(ips[ri]),
                    x=xwarm_by_req[ri],
                )
            for nr in feeder(ri, out) or ():
                nj = len(reqs)
                reqs.append(nr)
                results.append(np.zeros(self.k, dtype=np.int64))
                ips.append(0)
                infeasible.append(False)
                srhs_by_req.append(np.asarray(nr.rhs, dtype=np.float64).copy())
                perms.append(list(nr.perm))
                xwarm_by_req.append(None)
                still.append(
                    self._stage_task(
                        nj, 0, perms[nj], srhs_by_req[nj],
                        x_warm=getattr(nr, "x_hint", None),
                    )
                )

        for task in pool:
            if (task.nodes and not task.failed) or task.inflight > 0:
                still.append(task)
                continue
            ri = task.req_idx
            ips[ri] += 1
            if audit:
                with open(audit, "a") as fh:
                    fh.write(
                        f'{{"rhs": {list(map(float, srhs_by_req[ri]))}, '
                        f'"perm": {perms[ri]}, "stage": {task.stage}, '
                        f'"obj_j": {task.obj_j}, '
                        f'"failed": {str(task.failed).lower()}, '
                        f'"best": {float(task.best)}, '
                        f'"nodes": {task.node_count}}}\n'
                    )
            if task.failed:
                # exact host fallback for the whole request
                from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

                self.frag_stats["req_fallbacks"] = (
                    self.frag_stats.get("req_fallbacks", 0) + 1
                )
                with GLOBAL_TIMINGS.span("host.req_fallback"):
                    fb = self._fallback.lex_solve(reqs[ri])
                infeasible[ri] = fb.status.is_infeasible
                if fb.result is not None:
                    results[ri] = np.asarray(fb.result, dtype=np.int64)
                _request_done(ri)
                continue
            if not np.isfinite(task.best):
                infeasible[ri] = True
                _request_done(ri)
                continue
            val = task.best if self.is_min else -task.best
            vi = int(np.rint(val))
            results[ri][task.obj_j] = vi
            srhs_by_req[ri][task.obj_j] = float(vi)
            xwarm_by_req[ri] = task.best_x
            nxt = task.stage + 1
            if nxt < self.k:
                still.append(
                    self._stage_task(
                        ri, nxt, perms[ri], srhs_by_req[ri],
                        x_warm=xwarm_by_req[ri],
                    )
                )
            else:
                _request_done(ri)
        return still

    # -- main entry --------------------------------------------------------
    def lex_solve_batch(
        self, reqs: List[LexRequest], feeder=None
    ) -> List[LexOutcome]:
        """Run all requests to completion with TWO pipelined task pools:
        while the device solves pool A's LP wave, the host certifies,
        branches and re-submits pool B's — hiding the dispatch round-trip
        and the host bookkeeping behind device time.

        ``feeder``: see _advance_pool — completed requests can stream new
        ones into the pool, barrier-free."""
        if not reqs:
            return []
        reqs = list(reqs)
        n0 = len(reqs)
        results = [np.zeros(self.k, dtype=np.int64) for _ in range(n0)]
        ips = [0] * n0
        infeasible = [False] * n0
        srhs_by_req = [np.asarray(r.rhs, dtype=np.float64).copy() for r in reqs]
        perms = [list(r.perm) for r in reqs]
        xwarm_by_req = [None] * n0
        self._last_cert = None
        state = (reqs, results, ips, infeasible, srhs_by_req, perms, xwarm_by_req)

        pool = [
            self._stage_task(
                i, 0, perms[i], srhs_by_req[i],
                x_warm=getattr(reqs[i], "x_hint", None),
            )
            for i in range(n0)
        ]
        from collections import deque

        inflight = deque()
        B = self.batch_width
        while pool or inflight:
            # keep up to 2 waves in flight: the device solves one while the
            # host certifies/branches the other. A second wave is only worth
            # its dispatch cost when it can be reasonably full.
            while len(inflight) < 2:
                if inflight:
                    pending = sum(len(t.nodes) for t in pool)
                    if pending < B // 2:
                        break
                sub = self._submit_wave(pool)
                if sub is None:
                    break
                inflight.append(sub)
            if inflight:
                self._complete_wave(inflight.popleft(), state)
                pool = self._advance_pool(pool, state, feeder)
            else:
                # nothing submittable and nothing pending — but submit-time
                # pruning may have just emptied stacks, leaving finished
                # tasks to advance (and possibly next stages to start)
                drained = self._advance_pool(pool, state, feeder)
                if len(drained) == len(pool) and not any(
                    t.nodes for t in drained
                ):
                    pool = drained
                    break
                pool = drained

        out: List[LexOutcome] = []
        for i in range(len(reqs)):
            if infeasible[i]:
                out.append(LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[i])))
            else:
                out.append(
                    LexOutcome(
                        SolveStatus.OPTIMAL, results[i].copy(), int(ips[i]),
                        x=xwarm_by_req[i],
                    )
                )
        return out
