"""Inverse dynamics: tau = M(q) qdd + C(q, qd) qd + g(q).

Replaces the reference's recursive Newton-Euler implementation
(optas/models.py:1736-1888 `rnea`, restricted there to serial
revolute-only chains with a fixed first joint). The accelerator-first formulation
derives the same quantity from the Lagrangian with autodiff over the
framework's own batched FK:

    KE(q, qd) = 1/2 sum_l [ m_l |v_cl|^2 + w_l . (I_l^world w_l) ]
    PE(q)     = - sum_l m_l (gravity . p_cl)
    tau       = d/dt (dKE/dqd) - dKE/dq + dPE/dq

with link twists obtained in one `jax.jvp` through `fk_all` (no sequential
chain recursion, no joint-type restrictions — revolute, continuous, and
prismatic all flow through the same FK). The d/dt term is another jvp of
the qd-gradient along (qd, qdd). Everything is jit/vmap-safe.

Also provides mass_matrix / gravity_vector / coriolis_vector accessors
built from the same function (unit-vector probing).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.models.kinematics import _host_rt2tr


def _unskew(W):
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def make_inverse_dynamics(robot, gravity: Sequence[float] = (0.0, 0.0, -9.81)) -> Callable:
    """Build `idyn(q, qd, qdd) -> tau` for a RobotModel with URDF inertials."""
    masses = []
    com_local = []  # COM position in link frame
    inertia_local = []  # inertia tensor in link frame (about COM)
    frame_idx = []
    for link in robot.urdf.links:
        inr = link.inertial
        if inr is None or inr.mass <= 0.0:
            continue
        T_inr = _host_rt2tr(inr.rpy, inr.xyz)
        R_inr = T_inr[:3, :3]
        masses.append(inr.mass)
        com_local.append(T_inr[:3, 3])
        inertia_local.append(R_inr @ inr.inertia_matrix() @ R_inr.T)
        frame_idx.append(robot.frame_of(link.name))

    if not masses:
        raise ValueError(f"URDF '{robot.urdf.name}' has no inertial elements")

    dtype = robot.dtype
    m = jnp.asarray(np.asarray(masses), dtype)  # (L,)
    c_loc = jnp.asarray(np.asarray(com_local), dtype)  # (L, 3)
    I_loc = jnp.asarray(np.asarray(inertia_local), dtype)  # (L, 3, 3)
    fidx = jnp.asarray(np.asarray(frame_idx, dtype=np.int32))
    grav = jnp.asarray(gravity, dtype)

    def com_positions(q):
        frames = robot.fk_all(q)[fidx]  # (L, 4, 4)
        R = frames[:, :3, :3]
        p = frames[:, :3, 3]
        return p + jnp.einsum("lij,lj->li", R, c_loc), R

    def kinetic_energy(q, qd):
        (p_c, R), (v_c, dR) = jax.jvp(com_positions, (q,), (qd,))
        w = _unskew(dR @ jnp.swapaxes(R, -1, -2))  # world angular velocity
        I_w = R @ I_loc @ jnp.swapaxes(R, -1, -2)
        lin = jnp.sum(m * jnp.sum(v_c * v_c, axis=-1))
        ang = jnp.sum(w * jnp.einsum("lij,lj->li", I_w, w))
        return 0.5 * (lin + ang)

    def potential_energy(q):
        p_c, _ = com_positions(q)
        return -jnp.sum(m * (p_c @ grav))

    dKE_dqd = jax.grad(kinetic_energy, argnums=1)
    dKE_dq = jax.grad(kinetic_energy, argnums=0)
    dPE_dq = jax.grad(potential_energy)

    def idyn(q, qd, qdd):
        q = jnp.asarray(q, dtype)
        qd = jnp.asarray(qd, dtype)
        qdd = jnp.asarray(qdd, dtype)
        # d/dt of the generalized momentum along the trajectory (qd, qdd)
        _, dmom = jax.jvp(lambda qq, qqd: dKE_dqd(qq, qqd), (q, qd), (qd, qdd))
        return dmom - dKE_dq(q, qd) + dPE_dq(q)

    return idyn


def mass_matrix(robot, q, gravity=(0.0, 0.0, -9.81)):
    """M(q) by probing inverse dynamics with unit accelerations at qd=0,
    gravity removed."""
    idyn = make_inverse_dynamics(robot, gravity=(0.0, 0.0, 0.0))
    n = robot.ndof
    q = jnp.asarray(q, robot.dtype)
    zeros = jnp.zeros(n, robot.dtype)
    cols = jax.vmap(lambda e: idyn(q, zeros, e))(jnp.eye(n, dtype=robot.dtype))
    return cols.T


def gravity_vector(robot, q, gravity=(0.0, 0.0, -9.81)):
    idyn = make_inverse_dynamics(robot, gravity=gravity)
    zeros = jnp.zeros(robot.ndof, robot.dtype)
    return idyn(jnp.asarray(q, robot.dtype), zeros, zeros)


def coriolis_vector(robot, q, qd, gravity=(0.0, 0.0, -9.81)):
    idyn = make_inverse_dynamics(robot, gravity=(0.0, 0.0, 0.0))
    zeros = jnp.zeros(robot.ndof, robot.dtype)
    return idyn(jnp.asarray(q, robot.dtype), jnp.asarray(qd, robot.dtype), zeros)
