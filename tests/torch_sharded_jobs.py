"""The port's sharded fits, as jobs for the gloo ranks of tests/torch_dist.py
and as one-process fits for the tests themselves.

Imports the port and numpy only, never JAX: the ranks run without
tests/conftest.py.  Every fit starts from one numpy initial state (the
JAX package's init_state, made by the test), so the sharded and the
one-process fits and the JAX package's differ by summation order only.
"""

from __future__ import annotations

import contextlib
import os
import shutil

import numpy as np
import torch.distributed as dist

LAYOUTS = [(1, 4), (2, 2), (4, 1)]

# name -> (build_problem kwargs, FitConfig kwargs): test_sharding.py's fit
# (K=3, lambda 1, alpha 0.4, 20 iterations, seed 7), masked and dense, and
# at (2, 2) also cold CD and the alpha = 0 ridge fit; then the settings
# that the sharded fit runs at every layout since the segment-sum rows,
# the covariates, the checkpoints and the sanitizer were ported to it:
# every confounder on the segment-sum route (SEGMENT_SUM: the fast
# route's budget 0 in both packages), precompute=False masked and dense
# (the segment-sum rows, the covariates without constants), continuous
# covariates masked and dense (CTNS: how many), a fit checkpointed at
# boundary 10 and resumed to 20, and the clean fit under debug_checks
K, ITERS = 3, 20
BASE = dict(latent_dim=K, lambda1=1.0, lambda2=1.0, alpha=0.4,
            max_iter=ITERS, seed=7)
CASES = {
    "masked": (dict(masked=True), dict(masked=True)),
    "dense": (dict(masked=False), dict(masked=False)),
    "cold_cd": (dict(masked=True), dict(masked=True, col_solver="cd",
                                        cd_warm_start=False)),
    "ridge": (dict(masked=True), dict(masked=True, alpha=0.0)),
    # one boundary a dispatch: the chained fit of the others
    # (FitConfig's default boundaries_per_dispatch=5) must equal it
    "masked_unchained": (dict(masked=True), dict(
        masked=True, boundaries_per_dispatch=1)),
    "segment_sum": (dict(masked=True), dict(masked=True)),
    "no_precompute": (dict(masked=True, precompute=False),
                      dict(masked=True)),
    "no_precompute_dense": (dict(masked=False, precompute=False),
                            dict(masked=False)),
    "ctns": (dict(masked=True), dict(masked=True)),
    "ctns_dense": (dict(masked=False), dict(masked=False)),
    "checkpoint_resume": (dict(masked=True), dict(masked=True)),
    "debug_checks": (dict(masked=True), dict(masked=True,
                                             debug_checks=True)),
}
SEGMENT_SUM = ("segment_sum",)
CTNS = {"no_precompute": 2, "no_precompute_dense": 1, "ctns": 2,
        "ctns_dense": 1}
# the cases of the settings ported to the sharded fit last, each at every
# layout and against the JAX package's sharded fit at (2, 2)
SETTINGS = ("segment_sum", "no_precompute", "no_precompute_dense", "ctns",
            "ctns_dense", "checkpoint_resume", "debug_checks")
# the checkpointed fit's first run ends at this boundary
CKPT_AT = 10
EVERY_LAYOUT = ("masked", "dense") + SETTINGS
AT_2x2 = ("cold_cd", "ridge")
# the layouts that also fit "masked_unchained" (the group's four ranks
# hold no 1 x 2 layout; 1 x 4 splits the columns alone, 2 x 2 both axes)
UNCHAINED_LAYOUTS = [(1, 4), (2, 2)]


def summary(res) -> dict:
    """What the tests compare of an OptimizeResult."""
    return dict(
        history=[(h["iter"], h["loss"], h["train_rmse"], h["test_rmse"])
                 for h in res.history],
        n_iter=res.n_iter, converged=res.converged,
        F=np.asarray(res.column_factor), V=[np.asarray(v) for v in
                                            res.row_matrices],
        W=None if res.ctns_factor is None else np.asarray(res.ctns_factor))


@contextlib.contextmanager
def fast_budget(module, value):
    """module._FAST_E_BYTES set to value inside the block (0: every
    confounder takes the segment-sum route)."""
    saved = module._FAST_E_BYTES
    module._FAST_E_BYTES = value
    try:
        yield
    finally:
        module._FAST_E_BYTES = saved


def layout_tag(sharding) -> str:
    return "none" if sharding is None else f"{sharding.rows}x{sharding.cols}"


def ckpt_path(inp: dict, sharding, boundary=None) -> str:
    """The checkpoint of the "checkpoint_resume" fit at `sharding`, in the
    test's directory (which every rank shares); with boundary, the copy of
    it made at that boundary."""
    tail = "" if boundary is None else f"_at{boundary}"
    return os.path.join(inp["ckpt_dir"],
                        f"ckpt_{layout_tag(sharding)}{tail}.npz")


def build_case(inp: dict, case: str, sharding=None):
    """The problem of CASES[case] on the CPU, sharded or not."""
    from insider_tpu_torch.train import als

    build_kw, _ = CASES[case]
    ctns = inp["ctns"][:, :CTNS[case]] if case in CTNS else None
    with fast_budget(als, 0 if case in SEGMENT_SUM else als._FAST_E_BYTES):
        return als.build_problem(inp["data"], inp["confounder"],
                                 inp["train"], inp["test"], ctns,
                                 sharding=sharding, device="cpu", **build_kw)


def initial_state(inp: dict, case: str):
    """The JAX package's initial state of CASES[case] (with W where it
    has covariates) on the CPU."""
    from insider_tpu_torch.model.state import state_from_numpy

    cfd, W, F = inp["states"][CTNS.get(case, 0)]
    return state_from_numpy(cfd, W, F, "cpu")


def fit_case(inp: dict, case: str, sharding=None) -> dict:
    """One fit of CASES[case] on the CPU, sharded or not.  The
    "checkpoint_resume" fit runs to boundary CKPT_AT with a checkpoint
    (rank 0 then keeps a copy of it, ckpt_path(..., CKPT_AT)) and resumes
    from it to ITERS; its summary is the two runs' boundaries, with the
    saves each rank made (writes) and the file's whole F."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    problem = build_case(inp, case, sharding)
    cfg = FitConfig(**dict(BASE, **CASES[case][1]))
    if case != "checkpoint_resume":
        return summary(als.optimize(problem, cfg,
                                    state=initial_state(inp, case),
                                    verbose=False))
    from insider_tpu_torch.checkpoint import load_checkpoint

    path = ckpt_path(inp, sharding)
    writes = []
    saved = als.save_checkpoint

    def save(*a, **kw):
        writes.append(kw["it"])
        return saved(*a, **kw)

    als.save_checkpoint = save
    try:
        first = als.optimize(problem, FitConfig(**dict(
            BASE, **CASES[case][1], max_iter=CKPT_AT)),
            state=initial_state(inp, case), verbose=False,
            checkpoint_path=path)
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        if rank0:
            for ext in ("", ".json"):
                shutil.copy(path + ext, ckpt_path(inp, sharding, CKPT_AT)
                            + ext)
        second = als.optimize(problem, cfg, verbose=False,
                              checkpoint_path=path, resume=True)
    finally:
        als.save_checkpoint = saved
    out = summary(second)
    out["history"] = summary(first)["history"] + out["history"][1:]
    out["restored"] = summary(second)["history"][0]
    out["writes"] = writes
    out["file_F"] = load_checkpoint(path, device="cpu")[0].column_factor \
        .numpy()
    return out


def resume_case(inp: dict, path: str, sharding=None) -> dict:
    """The "checkpoint_resume" problem fitted to ITERS from the checkpoint
    at `path` (a copy: the run writes its own boundaries there)."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    problem = build_case(inp, "checkpoint_resume", sharding)
    cfg = FitConfig(**dict(BASE, **CASES["checkpoint_resume"][1]))
    return summary(als.optimize(problem, cfg, verbose=False,
                                checkpoint_path=path, resume=True))


def poisoned_fit(inp: dict, layout, sharded: bool, rank: int = 1) -> dict:
    """The "debug_checks" fit with a NaN put into the first element of
    `rank`'s block of `layout` that the train mask holds, on that rank of
    the sharded fit or at the same place of the one-process fit, once the
    initial loss is evaluated (from progress_callback: the fit would stop
    on a non-finite initial loss first), so the first iteration's column
    update reads it: the NonFiniteError's message (or None), where the
    NaN went in the whole matrix, and the collectives this rank called."""
    from insider_tpu_torch.config import FitConfig, ShardingConfig
    from insider_tpu_torch.sharding.distributed import (block_bounds,
                                                        group_rank)
    from insider_tpu_torch.train import als

    sharding = ShardingConfig(*layout) if sharded else None
    problem = build_case(inp, "debug_checks", sharding)
    r, c = divmod(rank, layout[1])
    r0, r1 = block_bounds(problem.shape[0], layout[0], r)
    c0, c1 = block_bounds(problem.shape[1], layout[1], c)
    i, j = map(int, np.argwhere(inp["train"][r0:r1, c0:c1] > 0)[0])

    def poison(rec):
        if rec["iter"] != -1:
            return
        if not sharded:
            problem.data[r0 + i, c0 + j] = float("nan")
        elif group_rank() == rank:
            problem.data[i, j] = float("nan")

    cfg = FitConfig(**dict(BASE, **CASES["debug_checks"][1]))
    message = None
    with _CountCollectives() as counter:
        try:
            als.optimize(problem, cfg, state=initial_state(
                inp, "debug_checks"), verbose=False,
                progress_callback=poison)
        except als.NonFiniteError as e:
            message = str(e)
    return dict(message=message, at=(r0 + i, c0 + j),
                collectives=counter.n)


def failed_save(inp: dict, sharding) -> dict:
    """The "checkpoint_resume" fit at `sharding` with rank 0's write of
    its first checkpoint raising ValueError (an error that is not an
    OSError): the type and message of the exception this rank raised."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.train import als

    problem = build_case(inp, "checkpoint_resume", sharding)
    cfg = FitConfig(**dict(BASE, **CASES["checkpoint_resume"][1]))
    saved = als.save_checkpoint

    def broken(*a, **kw):
        raise ValueError("rank 0's write failed")

    if dist.get_rank() == 0:
        als.save_checkpoint = broken
    try:
        als.optimize(problem, cfg, state=initial_state(
            inp, "checkpoint_resume"), verbose=False,
            checkpoint_path=ckpt_path(inp, sharding, "failed"))
    except Exception as e:
        return dict(type=type(e).__name__, message=str(e))
    finally:
        als.save_checkpoint = saved
    return dict(type=None, message=None)


def insider_fit(inp: dict, sharding=None, ctns=False) -> dict:
    """Insider(...).fit(K, 1.0, 0.4, partition=1) of the raw matrix, with
    the JAX package's initial state for it; with ctns, of the raw matrix
    and two covariates, from the state the fit draws."""
    import insider_tpu_torch as itt
    from insider_tpu_torch.model.state import state_from_numpy

    obj = itt.Insider(inp["raw"], inp["confounder"],
                      inp["ctns"] if ctns else None, max_iter=ITERS,
                      sharding=sharding, device="cpu")
    obj.fit(K, 1.0, 0.4, partition=1, verbose=False,
            state=None if ctns else state_from_numpy(
                inp["insider_cfd"], None, inp["insider_F"], "cpu"))
    return summary(obj.fit_result)


class _CountCollectives:
    """Counts the calls of torch.distributed's collectives and of
    new_group while active."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "barrier",
             "new_group")

    def __enter__(self):
        self.n, self.saved = 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name)
            self.saved[name] = fn

            def counted(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def sharding_job(inp: dict, rank: int) -> dict:
    """Every fit of the sharded tests on this rank's block."""
    from insider_tpu_torch.config import ShardingConfig

    out = {}
    for layout in LAYOUTS:
        cfg = ShardingConfig(*layout)
        for case in EVERY_LAYOUT + (AT_2x2 if layout == (2, 2) else ()) + (
                ("masked_unchained",) if layout in UNCHAINED_LAYOUTS
                else ()):
            out[case, layout] = fit_case(inp, case, cfg)
        out["poisoned", layout] = poisoned_fit(inp, layout, True)
    out["resumed from one process"] = resume_case(
        inp, inp["one_process_ckpt"], ShardingConfig(2, 2))
    out["failed save"] = failed_save(inp, ShardingConfig(2, 2))
    # after the poisoned fits and the failed save the group still runs a
    # fit: no rank was left in a collective
    out["insider"] = insider_fit(inp, ShardingConfig(2, 2))
    out["insider ctns"] = insider_fit(inp, ShardingConfig(2, 2), ctns=True)
    return out


INGEST_LAYOUTS = [(2, 2), (4, 1)]
INGEST_FIELDS = ("data", "train_mask", "test_mask", "codes", "d", "mw_cat",
                 "row_order", "max_level_count")
# a problem with covariates: masked, and dense (where the level sizes come
# from the precompute) and dense without constants (from the codes)
CTNS_FIELDS = {"masked": ("ctns", "ctns_q", "ctns_bc"),
               "dense": ("ctns", "ctns_dc", "ctns_cc", "counts"),
               "dense, precompute=False": ("ctns", "counts")}


def _same_problem(a, b, fields=INGEST_FIELDS) -> dict:
    """Field by field: are the two problems' tensors equal bit for bit?"""
    def same(x, y):
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
        if x is None or isinstance(x, float):
            return x == y
        return x.dtype == y.dtype and bool((x == y).all())

    return {f: same(getattr(a, f), getattr(b, f)) for f in fields}


def ingest_job(inp: dict, rank: int) -> dict:
    """build_problem_distributed from this rank's blocks and from
    callbacks, against build_problem(sharding=...); a fit from the
    callbacks' problem; and a fit from a raw f32 file through
    file_ingest_callbacks."""
    from insider_tpu_torch.config import FitConfig, ShardingConfig
    from insider_tpu_torch.data.native import file_ingest_callbacks
    from insider_tpu_torch.model.state import state_from_numpy
    from insider_tpu_torch.sharding import host_col_block, host_row_block
    from insider_tpu_torch.train import als

    x, tr, te, codes = inp["data"], inp["train"], inp["test"], inp["codes"]
    shape = x.shape
    out = {}
    for layout in INGEST_LAYOUTS:
        cfg = ShardingConfig(*layout)
        plain = als.build_problem(x, inp["confounder"], tr, te, sharding=cfg,
                                  device="cpu")
        r0, r1 = host_row_block(shape[0], cfg)
        c0, c1 = host_col_block(shape[1], cfg)
        blocks = als.build_problem_distributed(
            x[r0:r1, c0:c1], tr[r0:r1, c0:c1], te[r0:r1, c0:c1],
            [c[r0:r1] for c in codes], inp["n_levels"], shape, cfg,
            device="cpu")
        calls, ctns_calls = [], []

        def cb(name, a, log=calls):
            def call(index):
                log.append((name, tuple((s.start, s.stop) for s in index)))
                return a[index]
            return call

        from_cb = als.build_problem_distributed(
            cb("data", x), cb("train", tr), cb("test", te),
            [cb(f"codes{v}", c) for v, c in enumerate(codes)],
            inp["n_levels"], shape, cfg, device="cpu")
        res = als.optimize(from_cb, FitConfig(**dict(BASE, seed=0)),
                           state=state_from_numpy(inp["cfd"], None, inp["F"],
                                                  "cpu"), verbose=False)
        ctns = {}
        for kind, fields in CTNS_FIELDS.items():
            kw = dict(masked=kind == "masked",
                      precompute="precompute" not in kind, device="cpu")
            ref = als.build_problem(x, inp["confounder"], tr, te,
                                    inp["ctns"], sharding=cfg, **kw)
            got = [als.build_problem_distributed(
                x[r0:r1, c0:c1], tr[r0:r1, c0:c1], te[r0:r1, c0:c1],
                [c[r0:r1] for c in codes], inp["n_levels"], shape, cfg,
                ctns_confounder=inp["ctns"][r0:r1], **kw),
                als.build_problem_distributed(
                    x[r0:r1, c0:c1], tr[r0:r1, c0:c1], te[r0:r1, c0:c1],
                    [c[r0:r1] for c in codes], inp["n_levels"], shape, cfg,
                    ctns_confounder=cb("ctns", inp["ctns"], ctns_calls),
                    n_ctns=inp["ctns"].shape[1], **kw)]
            ctns[kind] = [_same_problem(g, ref, fields) for g in got]
        out[layout] = dict(
            blocks=_same_problem(blocks, plain),
            callbacks=_same_problem(from_cb, plain), calls=calls, ctns=ctns,
            ctns_calls=ctns_calls,
            block=((r0, r1), (c0, c1)),
            split_variants=(blocks.split_variant, from_cb.split_variant),
            fit=summary(res))
    data_cb, train_cb, test_cb = file_ingest_callbacks(
        inp["path"], inp["file_shape"], 0.1, 77)
    problem = als.build_problem_distributed(
        data_cb, train_cb, test_cb,
        [(lambda c: (lambda index: c[index]))(c) for c in inp["file_codes"]],
        inp["file_levels"],
        inp["file_shape"], ShardingConfig(2, 2), device="cpu")
    res = als.optimize(problem, FitConfig(**FILE_FIT), verbose=False)
    out["file"] = dict(split_variant=problem.split_variant,
                       fit=summary(res))
    return out


# the file-ingest fit of tests/test_native_io.py:166-213
FILE_FIT = dict(latent_dim=K, lambda1=1.0, lambda2=1.0, alpha=0.3,
                masked=True, max_iter=10, global_tol=0.0)
