"""Richardson-Lucy model facade.

Binds the algorithm knobs of the reference's ``workspace`` struct
(/root/reference/inc/multiviewnative.h:28-35) and our execution-strategy
axes (engine, view order, dispatch rung) into one configured object, so
callers hold a *model* rather than thread eight arguments through every
call."""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..deconv.dispatch import deconvolve_auto
from ..deconv.rl import deconvolve_jit
from ..deconv.workspace import MultiViewData, Workspace, initial_psi


@dataclasses.dataclass
class RichardsonLucy:
    """Bayesian multi-view RL (arXiv:1308.0730 Eq. 70).

    lambda_ > 0 selects the Tikhonov-regularized update
    (inc/cpu_kernels.h:59-90); view_order/algorithm/auto_dispatch pick the
    execution strategy."""

    num_iterations: int = 10
    lambda_: float = 0.0
    min_value: float = 1e-4
    view_order: str = "sequential"
    algorithm: str = "auto"
    auto_dispatch: bool = True
    initial: str = "average"
    adjoint_kernel2: bool = False

    def run(self, data: MultiViewData, psi0: Optional[jnp.ndarray] = None):
        if psi0 is None:
            psi0 = initial_psi(data, self.initial)
        if self.auto_dispatch:
            return deconvolve_auto(
                psi0,
                data,
                num_iterations=self.num_iterations,
                lam=self.lambda_,
                min_value=self.min_value,
                algorithm=self.algorithm,
                adjoint_kernel2=self.adjoint_kernel2,
                view_order=self.view_order,
            )
        return deconvolve_jit(
            psi0,
            data,
            num_iterations=self.num_iterations,
            lam=self.lambda_,
            min_value=self.min_value,
            view_order=self.view_order,
            algorithm=self.algorithm,
            adjoint_kernel2=self.adjoint_kernel2,
        )

    def run_workspace(self, ws: Workspace, psi0=None):
        model = dataclasses.replace(
            self,
            num_iterations=ws.num_iterations,
            lambda_=ws.lambda_,
            min_value=ws.min_value,
        )
        return model.run(ws.data, psi0)
