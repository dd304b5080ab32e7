"""The port's sharded fits, as jobs for the gloo ranks of tests/torch_dist.py
and as one-process fits for the tests themselves.

Imports the port and numpy only, never JAX: the ranks run without
tests/conftest.py.  Every fit starts from one numpy initial state (the
JAX package's init_state, made by the test), so the sharded and the
one-process fits and the JAX package's differ by summation order only.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

LAYOUTS = [(1, 4), (2, 2), (4, 1)]

# name -> (build_problem kwargs, FitConfig kwargs): test_sharding.py's fit
# (K=3, lambda 1, alpha 0.4, 20 iterations, seed 7), masked and dense, and
# at (2, 2) also cold CD and the alpha = 0 ridge fit
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
}
EVERY_LAYOUT = ("masked", "dense")
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
                                            res.row_matrices])


def fit_case(inp: dict, case: str, sharding=None) -> dict:
    """One fit of CASES[case] on the CPU, sharded or not."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.model.state import state_from_numpy
    from insider_tpu_torch.train import als

    build_kw, cfg_kw = CASES[case]
    problem = als.build_problem(inp["data"], inp["confounder"], inp["train"],
                                inp["test"], sharding=sharding, device="cpu",
                                **build_kw)
    state = state_from_numpy(inp["cfd"], None, inp["F"], "cpu")
    cfg = FitConfig(**dict(BASE, **cfg_kw))
    return summary(als.optimize(problem, cfg, state=state, verbose=False))


def insider_fit(inp: dict, sharding=None) -> dict:
    """Insider(...).fit(K, 1.0, 0.4, partition=1) of the raw matrix, with
    the JAX package's initial state for it."""
    import insider_tpu_torch as itt
    from insider_tpu_torch.model.state import state_from_numpy

    obj = itt.Insider(inp["raw"], inp["confounder"], max_iter=ITERS,
                      sharding=sharding, device="cpu")
    obj.fit(K, 1.0, 0.4, partition=1, verbose=False,
            state=state_from_numpy(inp["insider_cfd"], None,
                                   inp["insider_F"], "cpu"))
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


def refusals(inp: dict, sharding) -> dict:
    """Each unported combination under `sharding`: the NotImplementedError
    message it raised (or None) and the collectives called before it."""
    from insider_tpu_torch.config import FitConfig
    from insider_tpu_torch.model.state import state_from_numpy
    from insider_tpu_torch.train import als
    import insider_tpu_torch as itt

    args = (inp["data"], inp["confounder"], inp["train"], inp["test"])
    problem = als.build_problem(*args, sharding=sharding, device="cpu")
    state = state_from_numpy(inp["cfd"], None, inp["F"], "cpu")
    cfg = FitConfig(**dict(BASE, masked=True))
    ctns = np.linspace(0.0, 1.0, inp["data"].shape[0])

    def segment_sum():
        saved = als._FAST_E_BYTES
        als._FAST_E_BYTES = 0
        try:
            als.build_problem(*args, sharding=sharding, device="cpu")
        finally:
            als._FAST_E_BYTES = saved

    calls = {
        "ctns_confounder": lambda: als.build_problem(
            *args, ctns, sharding=sharding, device="cpu"),
        "Insider ctns_confounder": lambda: itt.Insider(
            inp["raw"], inp["confounder"], ctns, sharding=sharding,
            device="cpu"),
        "segment_sum": segment_sum,
        "no_precompute": lambda: als.build_problem(
            *args, sharding=sharding, precompute=False, device="cpu"),
        "checkpoint_path": lambda: als.optimize(
            problem, cfg, state=state, verbose=False,
            checkpoint_path="never-written.npz"),
        "resume": lambda: als.optimize(problem, cfg, state=state,
                                       verbose=False, resume=True),
        "debug_checks": lambda: als.optimize(
            problem, FitConfig(**dict(BASE, masked=True, debug_checks=True)),
            state=state, verbose=False),
    }
    out = {}
    for name, call in calls.items():
        with _CountCollectives() as counter:
            try:
                call()
                message = None
            except NotImplementedError as e:
                message = str(e)
        out[name] = (message, counter.n)
    return out


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
    out["refusals"] = refusals(inp, ShardingConfig(2, 2))
    # after the refusals the group still runs a fit: no rank was left in
    # a collective
    out["insider"] = insider_fit(inp, ShardingConfig(2, 2))
    return out


INGEST_LAYOUTS = [(2, 2), (4, 1)]
INGEST_FIELDS = ("data", "train_mask", "test_mask", "codes", "d", "mw_cat",
                 "row_order", "max_level_count")


def _same_problem(a, b) -> dict:
    """Field by field: are the two problems' tensors equal bit for bit?"""
    def same(x, y):
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(p, q) for p, q in zip(x, y))
        if x is None or isinstance(x, float):
            return x == y
        return x.dtype == y.dtype and bool((x == y).all())

    return {f: same(getattr(a, f), getattr(b, f)) for f in INGEST_FIELDS}


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
        calls = []

        def cb(name, a):
            def call(index):
                calls.append((name, tuple((s.start, s.stop) for s in index)))
                return a[index]
            return call

        from_cb = als.build_problem_distributed(
            cb("data", x), cb("train", tr), cb("test", te),
            [cb(f"codes{v}", c) for v, c in enumerate(codes)],
            inp["n_levels"], shape, cfg, device="cpu")
        res = als.optimize(from_cb, FitConfig(**dict(BASE, seed=0)),
                           state=state_from_numpy(inp["cfd"], None, inp["F"],
                                                  "cpu"), verbose=False)
        out[layout] = dict(
            blocks=_same_problem(blocks, plain),
            callbacks=_same_problem(from_cb, plain), calls=calls,
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
