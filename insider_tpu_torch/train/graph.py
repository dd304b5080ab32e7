"""One ALS iteration as a CUDA graph.

Counterpart of insider_tpu/train/als.py `_run_steps` / `_run_steps_eval`,
which run n iterations as one jitted fori_loop: here one iteration
(train/als._als_iteration, or _als_iteration_dense) is captured once per
optimize call with torch.cuda.graph and replayed once an iteration, so an
iteration's ~100 small launches cost one graph launch on the host.  The
boundary eval runs after the replays, eagerly.

The graph reads and writes static device buffers: the state (each V_v, W
and F), the column solvers' tolerance (one f32, which the column kernels
read by pointer, kernels/_lib.tol_on_device), for cold CD the (K,) int64
coordinate order, and a `done` flag.  At its end the graph copies the new
state into the state buffers unless `done` is set (torch.where), so a
chain of boundaries (train/als._run_boundary_chain) that stopped at one
leaves the state there, bit for bit, however many iterations it replays
after.

The fit's first iteration runs eagerly and is the capture's warm-up.
What capture needs of the iteration, and where it is held:
  - no host sync: the first iteration runs under
    torch.cuda.set_sync_debug_mode("error"), so a sync raises there;
    train/als.graph_route says which problems' routes are captured (the
    dense segment-sum counts are built once in build_problem for that);
  - no pageable host memory: cold CD's order is copied into its buffer,
    before each replay, from a pinned block that lives as long as the
    dispatch (run);
  - allocations (the wrappers' outputs and scratch) come from the graph's
    private pool at fixed addresses, and the streamed kernels' counter
    memset is captured with them.
The kernels' launch counts (`<wrapper>.launches`) tick where a wrapper
runs; the capture records its launches without running them, so the
counts are set back after it, and each replay adds the counts of one
captured iteration (`per_replay`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from insider_tpu_torch.model.state import InsiderState


def kernel_wrappers() -> Dict[str, Callable]:
    """{name: wrapper} of every kernel, each with its `launches` count."""
    from insider_tpu_torch.kernels import cd, ctns, eval as ev, fss, gram, row

    return {"level_gram": row.level_gram, "row_xty": row.row_xty,
            "feature_sign_fused": fss.feature_sign_fused,
            "masked_eval": ev.masked_eval,
            "col_gram_xty": gram.col_gram_xty,
            "feature_sign": fss.feature_sign,
            "feature_sign_shared": fss.feature_sign_shared,
            "cd_fused": cd.cd_fused, "cd_streamed": cd.cd_streamed,
            "cd_shared": cd.cd_shared, "ctns_cd": ctns.ctns_cd}


def _counts() -> Dict[str, int]:
    return {n: w.launches for n, w in kernel_wrappers().items()}


@contextlib.contextmanager
def _no_host_sync():
    """Raise on any host sync inside (torch's sync debug mode)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _leaves(state: InsiderState) -> List[torch.Tensor]:
    out = list(state.cfd_factors) + [state.column_factor]
    if state.ctns_factor is not None:
        out.append(state.ctns_factor)
    return out


def freeze(done: torch.Tensor, old: InsiderState,
           new: InsiderState) -> InsiderState:
    """new where done is False, else old: the state a stopped chain keeps
    (torch.where selects, so the bits are old's or new's exactly)."""
    def pick(a, b):
        return None if a is None else torch.where(done, a, b)

    return InsiderState([pick(a, b) for a, b in zip(old.cfd_factors,
                                                    new.cfd_factors)],
                        pick(old.ctns_factor, new.ctns_factor),
                        pick(old.column_factor, new.column_factor))


class IterationGraph:
    """The iterations of `iteration(problem, config, state, tol, perm)` on
    the problem's card: the first from `state` eagerly, at the tolerance
    `tol` (a float) and the cold-CD order `perm` (a (K,) int64 tensor on
    the card, or None), which is also the capture's warm-up (every kernel
    loaded, cuBLAS's handles made, off the capture) and is checked for host
    syncs; then the next one captured, from its result, in the static
    buffers.  The first's launches count as launches; the capture's do not
    (they are recorded, not run).

    state: the current state (the static buffers; read it between runs).
    tol, perm, done: the static tolerance, cold-CD order (None otherwise)
    and stop flag (`done`, a 0-d bool on the card, or a new one), which
    the caller writes on the stream before a run.
    capture_s: the seconds the first iteration and the capture took.
    per_replay: the kernels one replay launches, {name: count}.
    """

    def __init__(self, problem, config, state: InsiderState, iteration,
                 tol: float, perm: Optional[torch.Tensor] = None,
                 done: Optional[torch.Tensor] = None):
        dev = problem.device
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), _no_host_sync():
            first = iteration(problem, config, state, tol, perm)
        main.wait_stream(side)
        self.state = InsiderState(
            [v.clone() for v in first.cfd_factors],
            None if first.ctns_factor is None else first.ctns_factor.clone(),
            first.column_factor.clone())
        del first
        self.tol = torch.full((), tol, dtype=torch.float32, device=dev)
        self.perm = None if perm is None else perm.clone()
        self.done = (torch.zeros((), dtype=torch.bool, device=dev)
                     if done is None else done)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new = iteration(problem, config, self.state, self.tol, self.perm)
            for dst, src in zip(_leaves(self.state), _leaves(
                    freeze(self.done, self.state, new))):
                dst.copy_(src)
            del new
        wrappers = kernel_wrappers()
        self.per_replay = {n: wrappers[n].launches - c
                           for n, c in before.items()}
        for n, c in before.items():      # recorded, not launched
            wrappers[n].launches = c
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def run(self, n: int, perms: Optional[torch.Tensor] = None) -> None:
        """n replays on the current stream; perms: cold CD's (n, K) orders,
        one a replay, pinned host memory (the caller keeps it alive until
        the replays have run)."""
        for i in range(n):
            if perms is not None:
                self.perm.copy_(perms[i], non_blocking=True)
            self.graph.replay()
        wrappers = kernel_wrappers()
        for name, c in self.per_replay.items():
            wrappers[name].launches += n * c
