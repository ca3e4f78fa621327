#!/usr/bin/env python3
"""How far the JAX package's own sharded float32 KRR fit lies from its
single-device fit, on the CPU with forced host devices.

    PYTHONPATH=src python scripts/reference_mesh_spread.py

Prints, for the data of tests/test_distributed.py (λ = 5e-2, d = 16, m = 4)
and for the configuration of ``chip_smoke.py`` path (b) (λ = 1e-3, d = 64,
m = 4), the relative difference of the fitted values and of θ between
``krr_sketched_fit(..., mesh=D)`` and the single-device fit on the same
draw.  CᵀC summed in another order moves θ along the Woodbury system's
ill-conditioned directions; these spreads set the port's float32 mesh
tolerances (``chip_smoke.F32_FIT_TOL``, tests/test_torch_distributed.py).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as D  # noqa: E402
from repro.core.kernel_op import KernelOperator  # noqa: E402
from repro.core.krr import krr_sketched_fit  # noqa: E402
from repro.core.sketch import make_accum_sketch  # noqa: E402

KEY = jax.random.PRNGKey(0)


def rel(a, b) -> float:
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def spread(label, X, y, bandwidth, lam, d, m, sizes):
    n = X.shape[0]
    op = KernelOperator(X, "gaussian", bandwidth=bandwidth)
    sk = make_accum_sketch(KEY, n, d, m)
    one = krr_sketched_fit(op, y, lam, sk, use_kernel=False)
    for size in sizes:
        sh = krr_sketched_fit(op, y, lam, sk, mesh=D.make_data_mesh(size))
        print(f"{label} n={n} D={size}: fitted rel {rel(sh.fitted, one.fitted):.3e}, "
              f"θ rel {rel(sh.theta, one.theta):.3e}")


def main() -> None:
    for n in (320, 301):                       # tests/test_distributed.py _data
        X = jax.random.uniform(KEY, (n, 3))
        y = (jnp.sin(3.0 * X[:, 0]) + X[:, 1] ** 2
             + 0.2 * jax.random.normal(jax.random.fold_in(KEY, 1), (n,)))
        spread("test data, λ=5e-2, d=16", X, y, 0.6, 5e-2, 16, 4, (2, 3, 8))
    for n in (4095, 32767):                    # chip_smoke.py (b), scaled down
        k1, k2 = jax.random.split(KEY)
        X = jax.random.uniform(k1, (n, 3))
        y = (jnp.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
             + 0.3 * jax.random.normal(k2, (n,)))
        spread("path (b), λ=1e-3, d=64", X, y, 0.5, 1e-3, 64, 4, (2, 8))


if __name__ == "__main__":
    main()
