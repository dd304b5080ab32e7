"""Loss, prediction and RMSE evaluation.

Counterpart of insider_tpu/ops/losses.py (src/utils.cpp:37-102).  The JAX
package carries its sums as double-single (hi, lo) f32 pairs because the TPU
has no f64 (insider_tpu/ops/precise.py); the CPU and the H100 both do, so
every sum that feeds the 1e-9-relative stopping rule accumulates in float64
here.  The squares are of f32 values, so each is exact in f64.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch


def predict(row_factor: torch.Tensor, column_factor: torch.Tensor):
    """predictions = row_factor @ column_factor (src/utils.cpp:52-54)."""
    return torch.matmul(row_factor, column_factor)


class EvalSums(NamedTuple):
    """Masked residual sums, f64 scalar tensors."""
    train_sse: torch.Tensor
    test_sse: torch.Tensor
    n_train: torch.Tensor
    n_test: torch.Tensor


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return torch.sum(x * x)


def evaluate_masked(residual, train_mask, test_mask) -> EvalSums:
    """Masked train/test SSE (src/utils.cpp:64-67) of an f32 residual."""
    return EvalSums(
        _sum_squares(residual * train_mask),
        _sum_squares(residual * test_mask),
        torch.sum(train_mask, dtype=torch.float64),
        torch.sum(test_mask, dtype=torch.float64),
    )


def evaluate_dense(residual) -> EvalSums:
    """Whole-matrix SSE (src/utils.cpp:61-63): every element is a training
    element, and there is no test set."""
    zero = torch.zeros((), dtype=torch.float64, device=residual.device)
    # the count by a fill on the device: a copy from the host would wait
    # for the device (a chained boundary never waits for it)
    return EvalSums(_sum_squares(residual),
                    zero,
                    torch.full((), float(residual.numel()),
                               dtype=torch.float64, device=residual.device),
                    zero)


class LossSums(NamedTuple):
    """Pieces of the global objective (src/utils.cpp:79-102), f64 scalars."""
    row_reg: torch.Tensor   # sum_v ||V_v||_F^2 (incl. continuous W)
    col_l2: torch.Tensor    # ||F||_F^2
    col_l1: torch.Tensor    # sum |F|


def regularization_sums(cfd_factors: List[torch.Tensor],
                        ctns_factor: Optional[torch.Tensor],
                        column_factor: torch.Tensor) -> LossSums:
    rows = list(cfd_factors)
    if ctns_factor is not None:
        rows.append(ctns_factor)
    row_reg = sum(_sum_squares(f) for f in rows)
    return LossSums(
        row_reg=row_reg,
        col_l2=_sum_squares(column_factor),
        col_l1=torch.sum(column_factor.abs(), dtype=torch.float64),
    )


def pack_metrics(ev: EvalSums, reg: LossSums) -> torch.Tensor:
    """All eval/reg sums as ONE (7,) f64 vector, so a check boundary costs a
    single device-to-host copy."""
    return torch.stack([ev.train_sse, ev.test_sse, ev.n_train, ev.n_test,
                        reg.row_reg, reg.col_l2, reg.col_l1])


def finalize_metrics_vec(vec, lambda1: float, lambda2: float, alpha: float,
                         masked: bool) -> dict:
    """finalize_loss on a pack_metrics vector (host, f64)."""
    v = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec,
                   np.float64)
    return finalize_loss(EvalSums(*v[:4]), LossSums(*v[4:7]),
                         lambda1, lambda2, alpha, masked)


def finalize_loss(ev: EvalSums, reg: LossSums, lambda1: float, lambda2: float,
                  alpha: float, masked: bool) -> dict:
    """Host-side f64 combination: the reference's printed quantities.

    Returns the loss decomposition of src/utils.cpp:93-100 plus train/test
    RMSE of src/utils.cpp:61-67.
    """
    sum_residual = float(ev.train_sse)
    n_train = float(ev.n_train)
    train_rmse = math.sqrt(sum_residual / max(n_train, 1.0))
    if masked:
        n_test = float(ev.n_test)
        test_rmse = (math.sqrt(float(ev.test_sse) / max(n_test, 1.0))
                     if n_test else float("nan"))
    else:
        test_rmse = float("nan")
    row_reg = lambda1 * float(reg.row_reg)
    col_reg = lambda2 * (1.0 - alpha) * float(reg.col_l2)
    l1_reg = lambda2 * alpha * float(reg.col_l1)
    loss = sum_residual / 2.0 + row_reg / 2.0 + col_reg / 2.0 + l1_reg
    return {
        "loss": loss,
        "train_rmse": train_rmse,
        "test_rmse": test_rmse,
        "sum_residual": sum_residual,
        "row_reg_loss": row_reg / 2.0,
        "col_reg_loss": col_reg / 2.0,
        "l1_reg_loss": l1_reg,
    }
