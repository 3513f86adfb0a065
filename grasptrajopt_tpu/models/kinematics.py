"""Kinematics compiler: URDF tree -> flat arrays -> batched FK.

Accelerator-first redesign of the reference's per-link CasADi chain walk
(/root/reference/optas/models.py:828-868). Instead of building one symbolic
expression per link by walking root->link chains, we:

  1. flatten the whole tree into per-frame arrays (parent index, joint type,
     axis, fixed local transform, actuated-joint index) in topological order;
  2. compute ALL frames' joint-motion transforms in one vectorized op
     (Rodrigues over every revolute joint at once);
  3. compose world transforms with pointer-doubling over the parent links
     (parallel prefix on the tree): O(log depth) batched (F,4,4) matmul
     sweeps rather than a sequential chain walk.

The resulting `fk_all` is a pure function q -> (F, 4, 4), trivially
vmap-able over batch and trajectory axes and fully unrolled/static for XLA.

Joint types supported: fixed, revolute, continuous, prismatic — the same set
as the reference (optas/models.py:217 raises JointTypeNotSupported for the
rest).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

import jax.numpy as jnp

from grasptrajopt_tpu.models.urdf import Urdf
from grasptrajopt_tpu.spatial import angvec2r, rt2tr
from grasptrajopt_tpu.spatial.se3 import matmul_small

JOINT_FIXED = 0
JOINT_REVOLUTE = 1  # includes 'continuous'
JOINT_PRISMATIC = 2

_TYPE_CODE = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}


def _host_rt2tr(rpy, xyz) -> np.ndarray:
    """Host-side float64 fixed transform from URDF origin (numpy, so it
    stays exact regardless of the jax x64 flag)."""
    r, p, y = rpy

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    T = np.eye(4)
    T[:3, :3] = rz(y) @ ry(p) @ rx(r)
    T[:3, 3] = xyz
    return T


class JointTypeNotSupported(NotImplementedError):
    def __init__(self, joint_type: str):
        super().__init__(f"{joint_type} joints are not supported")


class KinematicModel:
    """Flat kinematic description of a URDF tree.

    Frames are links, ordered topologically with the root at index 0. All
    per-frame arrays are host numpy; `fk_all` closes over them so XLA sees
    them as constants.
    """

    def __init__(self, urdf: Urdf, actuated_joint_names: Optional[List[str]] = None):
        self.urdf = urdf
        root = urdf.get_root()

        if actuated_joint_names is None:
            actuated_joint_names = urdf.actuated_joint_names
        self.actuated_joint_names = list(actuated_joint_names)
        self.ndof = len(self.actuated_joint_names)
        joint_idx_of = {n: i for i, n in enumerate(self.actuated_joint_names)}

        # Topological order over links (children after parents).
        children: Dict[str, List[str]] = {}
        for j in urdf.joints:
            children.setdefault(j.parent, []).append(j.child)
        order: List[str] = []
        stack = [root]
        while stack:
            link = stack.pop()
            order.append(link)
            stack.extend(reversed(children.get(link, [])))
        self.frame_names: List[str] = order
        self.frame_index: Dict[str, int] = {n: i for i, n in enumerate(order)}

        F = len(order)
        parent = np.zeros(F, dtype=np.int32)
        joint_type = np.zeros(F, dtype=np.int32)
        joint_index = np.full(F, -1, dtype=np.int32)
        axis = np.zeros((F, 3), dtype=np.float64)
        axis[:, 0] = 1.0
        T_fixed = np.tile(np.eye(4), (F, 1, 1))

        for j in urdf.joints:
            f = self.frame_index[j.child]
            code = _TYPE_CODE.get(j.type)
            if code is None:
                raise JointTypeNotSupported(j.type)
            parent[f] = self.frame_index[j.parent]
            joint_type[f] = code
            if j.type != "fixed":
                joint_index[f] = joint_idx_of[j.name]
            axis[f] = np.asarray(j.axis, dtype=np.float64)
            T_fixed[f] = _host_rt2tr(j.rpy, j.xyz)

        self.parent = parent
        self.joint_type = joint_type
        self.joint_index = joint_index
        self.axis = axis
        self.T_fixed = T_fixed

        # Depth per frame (root = 0) and the pointer-doubling sweep count.
        depth = np.zeros(F, dtype=np.int32)
        for f in range(1, F):
            depth[f] = depth[parent[f]] + 1
        self.depth = depth
        self.num_doubling_sweeps = max(1, int(np.ceil(np.log2(depth.max() + 1)))) if F > 1 else 0

    def fk_fn(self, dtype=jnp.float32) -> Callable:
        """Compile an `fk_all(q) -> (F, 4, 4)` world-transform function.

        `q` has shape (..., ndof); output is (..., F, 4, 4). The composition
        uses pointer doubling over the parent pointers, so the number of
        batched matmul sweeps is ceil(log2(max_depth + 1)) regardless of the
        number of links.
        """
        parent0 = self.parent.copy()
        parent0[0] = 0  # root self-loop: its local transform is identity
        parent_j = jnp.asarray(parent0)
        jtype = jnp.asarray(self.joint_type)
        jindex = jnp.asarray(np.maximum(self.joint_index, 0))
        has_joint = jnp.asarray(self.joint_index >= 0)
        axis = jnp.asarray(self.axis, dtype=dtype)
        T_fixed = jnp.asarray(self.T_fixed, dtype=dtype)
        sweeps = self.num_doubling_sweeps
        eye3 = jnp.eye(3, dtype=dtype)

        def fk_all(q):
            q = jnp.asarray(q, dtype=dtype)
            qj = jnp.where(has_joint, q[..., jindex], jnp.zeros_like(q[..., jindex]))
            # Vectorized joint motion for every frame at once.
            R_rev = angvec2r(qj, axis)  # (..., F, 3, 3)
            is_rev = (jtype == JOINT_REVOLUTE)[..., None, None]
            is_pri = (jtype == JOINT_PRISMATIC)[..., None]
            R = jnp.where(is_rev, R_rev, eye3)
            t = jnp.where(is_pri, qj[..., None] * axis, jnp.zeros_like(axis))
            # elementwise small-matmul: 4x4 products are too small for a matrix unit
            local = matmul_small(T_fixed, rt2tr(R, t))  # (..., F, 4, 4)
            local = local.at[..., 0, :, :].set(jnp.eye(4, dtype=dtype))

            # Pointer doubling: after k sweeps, acc[f] composes 2^k ancestors.
            acc, ptr = local, parent_j
            for _ in range(sweeps):
                acc = matmul_small(jnp.take(acc, ptr, axis=-3), acc)
                ptr = ptr[ptr]
            return acc

        return fk_all

    def frame_of(self, link_name: str) -> int:
        if link_name not in self.frame_index:
            raise KeyError(f"link '{link_name}' does not appear in URDF '{self.urdf.name}'")
        return self.frame_index[link_name]

    def fk_components_fn(self, dtype=jnp.float32) -> Callable:
        """Compile `fk_comp(q) -> (R (..., F, 3, 3 as 9 comps), t)` in
        COMPONENT form: twelve (..., F) arrays (r00..r22, t0..t2).

        Same math as `fk_fn`, but no (..., 4, 4) tensors are ever
        materialized: tiled device layouts can pad trailing tiny dims, and
        the stack/concat/gather mix inside the matrix formulation forces
        those layouts onto every intermediate, where the component form
        is bandwidth-trivial. All arithmetic here is
        elementwise over (..., F) with the doubling gathers on the last
        axis. Returns (R, t) stacked as (..., F, 3, 3) and (..., F, 3)
        only at the very end for consumers that want matrices; use
        `fk_surface_points`-style consumers on raw components to stay
        layout-clean end to end.
        """
        parent0 = self.parent.copy()
        parent0[0] = 0
        ptr0 = jnp.asarray(parent0)
        jindex = jnp.asarray(np.maximum(self.joint_index, 0))
        has_joint = jnp.asarray(self.joint_index >= 0)
        is_rev = jnp.asarray(self.joint_type == JOINT_REVOLUTE)
        is_pri = jnp.asarray(self.joint_type == JOINT_PRISMATIC)
        ax = jnp.asarray(self.axis, dtype=dtype)  # (F, 3)
        axn = ax / jnp.maximum(jnp.linalg.norm(ax, axis=-1, keepdims=True), 1e-12)
        Tf = jnp.asarray(self.T_fixed, dtype=dtype)  # (F, 4, 4) host constant
        sweeps = self.num_doubling_sweeps

        # fixed-transform components as (F,) constants
        FR = [[Tf[:, i, j] for j in range(3)] for i in range(3)]
        Ft = [Tf[:, i, 3] for i in range(3)]
        axc = [axn[:, i] for i in range(3)]  # normalized (revolute Rodrigues)
        axr = [ax[:, i] for i in range(3)]  # raw (prismatic, reference parity)

        def fk_components(q):
            q = jnp.asarray(q, dtype)
            qj = jnp.where(has_joint, q[..., jindex], 0.0)  # (..., F)
            c = jnp.cos(qj)
            s = jnp.sin(qj)
            one_c = 1.0 - c

            # Rodrigues rotation components about the (unit) joint axis,
            # identity where the joint is not revolute
            rev = is_rev.astype(dtype)
            # blend: rev * rodrigues + (1 - rev) * identity
            def rod(i, j):
                a_i = axc[i]
                a_j = axc[j]
                eye = 1.0 if i == j else 0.0
                # skew contribution eps_{ijk} a_k
                k = 3 - i - j
                sign = {(0, 1): -1.0, (1, 0): 1.0, (0, 2): 1.0, (2, 0): -1.0,
                        (1, 2): -1.0, (2, 1): 1.0}.get((i, j), 0.0)
                skew_term = sign * axc[k] if sign else 0.0
                val = eye * c + one_c * a_i * a_j
                if sign:
                    val = val + s * skew_term
                return rev * val + (1.0 - rev) * eye

            # joint-local = T_fixed @ [R_joint | t_joint]
            pri = is_pri.astype(dtype)
            tj = [pri * qj * axr[i] for i in range(3)]  # prismatic translation
            J = [[rod(i, j) for j in range(3)] for i in range(3)]

            # local rotation = FR @ J ; local translation = FR @ tj + Ft
            LR = [[sum(FR[i][k] * J[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
            Lt = [sum(FR[i][k] * tj[k] for k in range(3)) + Ft[i] for i in range(3)]

            # root frame is identity
            root_mask = jnp.zeros(LR[0][0].shape[-1], dtype).at[0].set(1.0)
            for i in range(3):
                for j in range(3):
                    LR[i][j] = LR[i][j] * (1 - root_mask) + (1.0 if i == j else 0.0) * root_mask
                Lt[i] = Lt[i] * (1 - root_mask)

            # pointer doubling on components
            ptr = ptr0
            AR, At = LR, Lt
            for _ in range(sweeps):
                PR = [[jnp.take(AR[i][j], ptr, axis=-1) for j in range(3)] for i in range(3)]
                Pt = [jnp.take(At[i], ptr, axis=-1) for i in range(3)]
                NR = [[sum(PR[i][k] * AR[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
                Nt = [sum(PR[i][k] * At[k] for k in range(3)) + Pt[i] for i in range(3)]
                AR, At = NR, Nt
                ptr = ptr[ptr]
            return AR, At

        return fk_components
