"""Typed solver configurations.

Counterpart of the JAX package's ``utils/configs.py``: the same frozen
dataclasses, field names and defaults. They give the untyped keyword
arguments of ``sparse_encode(**kwargs)`` a typed, hashable form, and
``encode`` binds a config to the port's dispatcher.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from lasso_tpu_torch.linear.sparse_encode import sparse_encode


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    algorithm: str = "ista"
    init: Optional[str] = None

    def kwargs(self):
        d = dataclasses.asdict(self)
        d.pop("algorithm")
        d.pop("init")
        return {k: v for k, v in d.items() if v is not None}

    def encode(self, x, weight, alpha=1.0, z0=None, generator=None):
        """``sparse_encode`` with this config's algorithm, init and
        solver keywords (``key`` becomes ``generator``)."""
        return sparse_encode(x, weight, alpha, z0=z0,
                             algorithm=self.algorithm, init=self.init,
                             generator=generator, **self.kwargs())


@dataclasses.dataclass(frozen=True)
class IstaConfig(SolverConfig):
    algorithm: str = "ista"
    fast: bool = True
    lr: Union[str, float] = "auto"
    maxiter: int = 10
    tol: float = 1e-5
    backtrack: bool = False
    eta_backtrack: float = 1.5
    use_pallas: Union[str, bool] = "auto"
    kernel_precision: str = "f32"
    fuse_steps: Union[str, int] = "auto"
    restart: bool = False


@dataclasses.dataclass(frozen=True)
class CoordDescentConfig(SolverConfig):
    algorithm: str = "cd"
    maxiter: int = 1000
    tol: float = 1e-6


@dataclasses.dataclass(frozen=True)
class GpsrConfig(SolverConfig):
    algorithm: str = "gpsr"
    stop_criterion: int = 3
    tol: float = 1e-2
    maxiter: int = 1000
    miniter: int = 5
    continuation: bool = False
    debias: bool = False


@dataclasses.dataclass(frozen=True)
class IterativeRidgeConfig(SolverConfig):
    algorithm: str = "iter-ridge"
    init: Optional[str] = "ridge"
    tol: float = 1e-5
    tikhonov: float = 1e-4
    maxiter: int = 10
    line_search: bool = True
    cg: bool = False


@dataclasses.dataclass(frozen=True)
class InteriorPointConfig(SolverConfig):
    algorithm: str = "interior-point"
    init: Optional[str] = "ridge"
    maxiter: int = 20
    barrier_init: float = 0.1
    tol: float = 1e-2
    kkt_solver: str = "auto"


@dataclasses.dataclass(frozen=True)
class SplitBregmanConfig(SolverConfig):
    algorithm: str = "split-bregman"
    lambd: float = 1.0
    maxiter: int = 20
    niter_inner: int = 5
    tau: float = 1.0


@dataclasses.dataclass(frozen=True)
class OrthantWiseNewtonConfig(SolverConfig):
    algorithm: str = "own"
    lr: float = 1.0
    maxiter: int = 20
    xtol: float = 1e-5
    line_search: str = "brent"


CONFIGS = {
    "ista": IstaConfig,
    "cd": CoordDescentConfig,
    "gpsr": GpsrConfig,
    "iter-ridge": IterativeRidgeConfig,
    "interior-point": InteriorPointConfig,
    "split-bregman": SplitBregmanConfig,
    "own": OrthantWiseNewtonConfig,
}


def config_for(algorithm: str, **overrides) -> SolverConfig:
    """Build the typed config for an algorithm name with field overrides."""
    try:
        cls = CONFIGS[algorithm]
    except KeyError:
        raise ValueError(f"unknown algorithm {algorithm!r}") \
            from None
    return cls(**overrides)
