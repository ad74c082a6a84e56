"""compute_step traces to the same program whatever the backend, with every
product pinned to full float32 precision (no TF32 on a GPU)."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from obvi_slam_tpu.solver import schur
from obvi_slam_tpu.synthetic import synthetic_problem


def _problem(n_poses):
    return synthetic_problem(
        n_poses=n_poses, n_points=4 * n_poses, n_objects=4, obs_per_point=4,
        obs_per_object=6, dtype=np.float32,
    )


def _jaxpr(n_poses=16, dense_schur=None):
    state0, _, cams, tables, plan, free, weights, huber = _problem(n_poses)
    radius = jnp.asarray(1e4, jnp.float32)
    return jax.make_jaxpr(
        lambda *a: schur.compute_step(*a, huber, dense_schur=dense_schur)
    )(state0, cams, tables, plan, free, weights, radius)


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _sub_jaxprs(v)


def _eqns(jaxpr):
    """Every equation of ``jaxpr``, nested jaxprs (jit, cond, while) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _eqns(sub)


def test_program_does_not_depend_on_backend(monkeypatch):
    on_cpu = str(_jaxpr())
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert str(_jaxpr()) == on_cpu


# 16 poses: dense reduced solve; 192: band layout, dense solve; 512: band
# layout with the block-tridiagonal + Woodbury solve; dense_schur=False: the
# per-landmark pose-pair Schur path instead of the dense U product.
@pytest.mark.parametrize(
    "n_poses, dense_schur",
    [(16, None), (192, None), (512, None), (192, False)],
)
def test_no_kernel_and_every_dot_at_highest(n_poses, dense_schur):
    if n_poses >= 512:
        assert schur.band_engagement(_problem(n_poses)[4], n_poses) == (
            True, True)
    eqns = list(_eqns(_jaxpr(n_poses, dense_schur).jaxpr))
    names = {e.primitive.name for e in eqns}
    assert "pallas_call" not in names
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None, e
        assert all(p == jax.lax.Precision.HIGHEST for p in prec), e
