"""Pose-graph optimization over keyframe poses.

Nodes are world<-camera SE(3) poses; edges carry measured relative
transforms ``Z_ij ~ T_i^{-1} T_j`` (odometry and loop closures). Gauss-
Newton on the se(3) residual ``log(Z_ij^{-1} T_i^{-1} T_j)`` with numeric
Jacobians via jax.jacfwd over local perturbations (graphs are small —
keyframes only — so the dense [6N, 6N] system is fine on device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.slam.lie import se3_exp, se3_inv, se3_log


class PoseGraph(NamedTuple):
    poses: jnp.ndarray       # [N, 4, 4]
    edge_i: jnp.ndarray      # [E] int32
    edge_j: jnp.ndarray      # [E] int32
    edge_z: jnp.ndarray      # [E, 4, 4] measured T_i^-1 T_j
    edge_weight: jnp.ndarray  # [E]


def _edge_residual(ti, tj, z):
    return se3_log(se3_inv(z) @ se3_inv(ti) @ tj)


def _perturb(t, xi):
    return t @ se3_exp(xi)


@functools.partial(jax.jit, static_argnames=("iterations",))
def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-6) -> Tuple[PoseGraph, jnp.ndarray]:
    """Gauss-Newton with pose 0 gauge-fixed. Returns (graph', chi2[iters]).

    Traced under float32 matmul precision — reduced-precision matmuls
    (TF32 on an H100) wreck Gauss-Newton linear algebra (see
    ba.solve_window); no-op on CPU."""
    n = graph.poses.shape[0]

    def residual_jac(ti, tj, z):
        zero = jnp.zeros(6)
        r = _edge_residual(ti, tj, z)
        ji = jax.jacfwd(lambda xi: _edge_residual(_perturb(ti, xi), tj, z)
                        )(zero)
        jj = jax.jacfwd(lambda xi: _edge_residual(ti, _perturb(tj, xi), z)
                        )(zero)
        return r, ji, jj

    def body(poses, _):
        ti = poses[graph.edge_i]
        tj = poses[graph.edge_j]
        r, ji, jj = jax.vmap(residual_jac)(ti, tj, graph.edge_z)
        w = graph.edge_weight
        chi2 = jnp.sum(w * jnp.sum(r * r, axis=-1))

        h = jnp.zeros((6 * n, 6 * n))
        b = jnp.zeros((6 * n,))
        wi = ji * w[:, None, None]
        wj = jj * w[:, None, None]

        def scat(h, b, idx_a, ja, idx_b, jb):
            blocks = jnp.einsum("eik,eil->ekl", ja, jb)   # [E, 6, 6]
            def upd(e, acc):
                hh = acc
                return jax.lax.dynamic_update_slice(
                    hh, jax.lax.dynamic_slice(
                        hh, (6 * idx_a[e], 6 * idx_b[e]), (6, 6))
                    + blocks[e],
                    (6 * idx_a[e], 6 * idx_b[e]))
            return jax.lax.fori_loop(0, idx_a.shape[0], upd, h)

        h = scat(h, b, graph.edge_i, wi, graph.edge_i, ji)
        h = scat(h, b, graph.edge_i, wi, graph.edge_j, jj)
        h = scat(h, b, graph.edge_j, wj, graph.edge_i, ji)
        h = scat(h, b, graph.edge_j, wj, graph.edge_j, jj)

        bi = -jnp.einsum("eik,ei->ek", wi, r)
        bj = -jnp.einsum("eik,ei->ek", wj, r)
        b = b.at[(graph.edge_i[:, None] * 6
                  + jnp.arange(6)[None, :]).reshape(-1)].add(bi.reshape(-1))
        b = b.at[(graph.edge_j[:, None] * 6
                  + jnp.arange(6)[None, :]).reshape(-1)].add(bj.reshape(-1))

        # gauge fix node 0
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (n - 1))])
        h = h * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        h = h + damping * jnp.eye(6 * n)
        b = b * mask
        delta = jnp.linalg.solve(h, b).reshape(n, 6)
        poses = jax.vmap(_perturb)(poses, delta)
        return poses, chi2

    with jax.default_matmul_precision("float32"):
        poses, chi2s = jax.lax.scan(body, graph.poses, None,
                                    length=iterations)
    return graph._replace(poses=poses), chi2s
