"""Linear regression on the device: the port of incubator_predictionio_tpu/
ops/linreg.py, the regression template's solvers.

- :func:`linreg_fit`: closed-form ridge by the normal equations, the
  local example's exact solve (examples/experimental/
  scala-local-regression/Run.scala). One K×K Cholesky; the cost is the
  [N, K] Gram. It takes a batch too: ``x`` [..., N, K] and ``y`` [..., N]
  give [..., K+1], one batched factorization, which is how the stock
  template fits every ticker at once (the JAX package ``vmap``s it).
- :func:`linreg_fit_sgd`: full-batch gradient descent, the parallel
  example's LinearRegressionWithSGD (scala-parallel-regression/
  Run.scala), one step a loop iteration.

Both learn an intercept through a constant column and return the weights
with the intercept last. No Pallas kernel stands behind them in the JAX
package (XLA computes the products and ``cho_factor``), so here they are
PyTorch calls on the inputs' device, in f32 as there.

A Gram that is not positive definite (a duplicated column at ``l2`` 0,
which the regression quickstart's ``linear`` algorithm reaches) gives
NaN weights, as JAX's ``cho_factor`` does: ``cholesky_ex`` reports the
failed pivot and the solve of that system is replaced by NaN. Nothing
falls back to another solve.
"""

from __future__ import annotations

import torch


def _augment(x: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)


def linreg_fit(x: torch.Tensor, y: torch.Tensor, l2: float = 0.0
               ) -> torch.Tensor:
    """Ridge normal equations: (XᵗX + λI) w = Xᵗy → w [..., K+1]."""
    xa = _augment(x.to(torch.float32))
    k = xa.shape[-1]
    xt = xa.transpose(-1, -2)
    gram = xt @ xa + l2 * torch.eye(k, dtype=torch.float32, device=xa.device)
    rhs = (xt @ y.to(torch.float32).unsqueeze(-1))
    chol, info = torch.linalg.cholesky_ex(gram)
    w = torch.cholesky_solve(rhs, chol).squeeze(-1)
    return torch.where((info > 0).unsqueeze(-1),
                       torch.full_like(w, float("nan")), w)


def linreg_fit_sgd(
    x: torch.Tensor,
    y: torch.Tensor,
    steps: int = 200,
    step_size: float = 0.1,
    l2: float = 0.0,
) -> torch.Tensor:
    """Full-batch gradient descent on the MSE (LinearRegressionWithSGD's
    role; full-batch, as in the JAX package, because the design matrix sits
    on the device whole)."""
    xa = _augment(x.to(torch.float32))
    ya = y.to(torch.float32)
    n = xa.shape[0]
    w = torch.zeros((xa.shape[1],), dtype=torch.float32, device=xa.device)
    for _ in range(steps):
        grad = xa.T @ (xa @ w - ya) / n + l2 * w
        w = w - step_size * grad
    return w


def linreg_predict(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Predictions for a [N, K] feature batch → [N]."""
    return _augment(x.to(torch.float32)) @ w
