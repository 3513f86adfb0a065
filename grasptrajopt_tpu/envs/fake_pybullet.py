"""Kinematic PyBullet emulator: a drop-in `pybullet` module for headless use.

The reference establishes quality exclusively through closed-loop PyBullet
runs (SURVEY.md §4) and has no fake/mock backends, so nothing in its
simulation layer is testable without the real physics engine. This module
fills that slot for this framework: it implements the exact pybullet API
surface used by `envs/pybullet_api.py` and `envs/scene_replica.py`
(connect/loadURDF/joint control/link states/camera images/IK) on top of the
framework's own first-party pieces — the URDF parser (`models/urdf.py`),
host FK, mesh loaders (`models/mesh.py`) and the software z-buffer renderer
(`envs/render.py`). Everything is kinematic: position-controlled joints
slew toward their targets at the joint velocity limit, differential-drive
wheel commands integrate the base pose, and an optional grasp rule attaches
an object to the gripper when the fingers close around it (the stand-in for
contact physics, enough to exercise the reward path of
/root/reference/examples/pybullet_scenereplica.py:574-589).

Use `fake_pybullet.install()` before importing the simulation layer to
register this module as `sys.modules["pybullet"]` when the real engine is
absent. API constants match pybullet's numeric values where observable.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- pybullet API constants (numeric values match the real module) ------------
DIRECT = 1
GUI = 2

JOINT_REVOLUTE = 0
JOINT_PRISMATIC = 1
JOINT_SPHERICAL = 2
JOINT_PLANAR = 3
JOINT_FIXED = 4

VELOCITY_CONTROL = 0
TORQUE_CONTROL = 1
POSITION_CONTROL = 2

GEOM_SPHERE = 2
GEOM_BOX = 3
GEOM_CYLINDER = 4
GEOM_MESH = 5
GEOM_PLANE = 6

COV_ENABLE_GUI = 1
URDF_ENABLE_CACHED_GRAPHICS_SHAPES = 8

_TYPE_CODE = {
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
    "fixed": JOINT_FIXED,
    "floating": JOINT_FIXED,
    "planar": JOINT_PLANAR,
}


def _rpy_matrix(rpy) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin_tf(xyz, rpy) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rpy_matrix(rpy)
    T[:3, 3] = xyz
    return T


def _axis_tf(jtype: int, axis, q: float) -> np.ndarray:
    T = np.eye(4)
    a = np.asarray(axis, dtype=float)
    n = np.linalg.norm(a)
    a = a / n if n > 0 else np.array([1.0, 0.0, 0.0])
    if jtype == JOINT_PRISMATIC:
        T[:3, 3] = a * q
        return T
    if jtype == JOINT_REVOLUTE:
        c, s = math.cos(q), math.sin(q)
        x, y, z = a
        C = 1 - c
        T[:3, :3] = np.array(
            [
                [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
                [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
            ]
        )
    return T


def _mat_to_quat_xyzw(R: np.ndarray) -> Tuple[float, float, float, float]:
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q[0], q[1], q[2], q[3]
    return (float(x), float(y), float(z), float(w))


def _quat_xyzw_to_mat(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    n = math.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class _Body:
    """One simulated body: a URDF tree or a primitive multibody."""

    def __init__(self, uid: int):
        self.uid = uid
        self.base_pose = np.eye(4)
        self.base_mass = 0.0
        self.fixed = True
        # per-joint arrays (URDF joint order; link index i = child of joint i)
        self.joint_names: List[str] = []
        self.joint_types: List[int] = []
        self.joint_parent_link: List[int] = []
        self.joint_axes: List[np.ndarray] = []
        self.joint_origins: List[np.ndarray] = []
        self.joint_limits: List[Tuple[float, float]] = []
        self.joint_maxvel: List[float] = []
        self.link_names: List[str] = []
        self.q: np.ndarray = np.zeros(0)
        self.qd: np.ndarray = np.zeros(0)
        self.targets: Dict[int, float] = {}  # position-control targets
        self.wheel_vel: Dict[int, float] = {}  # velocity-control targets
        self.urdf = None
        self.urdf_dir = ""
        self._visual_cache = None  # [(link_idx, local_tf, TriangleMesh)]
        self.attached: Optional[Tuple[int, int, np.ndarray]] = None  # obj uid, ee link, rel tf

    # -- construction --------------------------------------------------------

    @classmethod
    def from_urdf(cls, uid, filename, base_pos, base_orn_xyzw, fixed) -> "_Body":
        from grasptrajopt_tpu.models.urdf import parse_urdf_file

        body = cls(uid)
        body.urdf = parse_urdf_file(filename)
        body.urdf_dir = os.path.dirname(os.path.abspath(filename))
        body.fixed = bool(fixed)
        body.base_mass = 0.0 if fixed else 1.0
        body.base_pose = _origin_tf(base_pos, (0, 0, 0))
        body.base_pose[:3, :3] = _quat_xyzw_to_mat(base_orn_xyzw)

        # pybullet numbers joints by DEPTH-FIRST traversal of the link tree
        # (children in file order), NOT by file order — the reference's
        # hardcoded indices (Fetch ee_index=16, camera=7; Panda ee=7,
        # camera=10, envs/pybullet_api.py) only line up under DFS.
        children: Dict[str, list] = {}
        for j in body.urdf.joints:
            children.setdefault(j.parent, []).append(j)
        link_index = {body.urdf.get_root(): -1}

        def _add_subtree(link_name: str) -> None:
            for j in children.get(link_name, []):
                idx = len(body.joint_names)
                body.joint_names.append(j.name)
                body.joint_types.append(_TYPE_CODE.get(j.type, JOINT_FIXED))
                body.joint_parent_link.append(link_index[j.parent])
                body.joint_axes.append(np.asarray(j.axis, dtype=float))
                body.joint_origins.append(_origin_tf(j.xyz, j.rpy))
                lim = j.limit
                lo = lim.lower if lim and lim.lower is not None else -1e9
                hi = lim.upper if lim and lim.upper is not None else 1e9
                vmax = lim.velocity if lim and lim.velocity else 1.0
                body.joint_limits.append((float(lo), float(hi)))
                body.joint_maxvel.append(float(vmax))
                body.link_names.append(j.child)
                link_index[j.child] = idx
                _add_subtree(j.child)

        _add_subtree(body.urdf.get_root())
        if len(body.joint_names) != len(body.urdf.joints):
            raise ValueError(f"URDF joint tree disconnected in {filename}")
        n = len(body.joint_names)
        body.q = np.zeros(n)
        body.qd = np.zeros(n)
        return body

    @classmethod
    def from_primitive(cls, uid, mesh, base_pos, mass) -> "_Body":
        body = cls(uid)
        body.base_pose = _origin_tf(base_pos, (0, 0, 0))
        body.base_mass = float(mass)
        body.fixed = mass == 0.0
        body._visual_cache = [(-1, np.eye(4), mesh)] if mesh is not None else []
        return body

    # -- kinematics ----------------------------------------------------------

    def movable_joints(self) -> List[int]:
        return [i for i, t in enumerate(self.joint_types) if t in (JOINT_REVOLUTE, JOINT_PRISMATIC)]

    def link_transforms(self) -> List[np.ndarray]:
        """World transform per link index (joint order)."""
        out: List[np.ndarray] = []
        for i in range(len(self.joint_names)):
            parent = self.joint_parent_link[i]
            T_parent = self.base_pose if parent < 0 else out[parent]
            T = T_parent @ self.joint_origins[i]
            if self.joint_types[i] in (JOINT_REVOLUTE, JOINT_PRISMATIC):
                T = T @ _axis_tf(self.joint_types[i], self.joint_axes[i], self.q[i])
            out.append(T)
        return out

    def link_transform(self, link_index: int) -> np.ndarray:
        if link_index < 0:
            return self.base_pose
        return self.link_transforms()[link_index]

    def visual_meshes(self):
        """[(link_idx, local_tf, mesh)]; lazy, failures skipped."""
        if self._visual_cache is None:
            from grasptrajopt_tpu.models.mesh import geometry_mesh

            cache = []
            names = [self.urdf.get_root()] + self.link_names
            for li, name in zip([-1] + list(range(len(self.link_names))), names):
                link = self.urdf.link_map.get(name)
                if link is None:
                    continue
                for vis in link.visuals:
                    try:
                        mesh = geometry_mesh(vis.geometry, self.urdf_dir)
                    except Exception:
                        mesh = None
                    if mesh is not None:
                        cache.append((li, _origin_tf(vis.xyz, vis.rpy), mesh))
            self._visual_cache = cache
        return self._visual_cache


class _GraspRule:
    def __init__(self, robot_uid, ee_link, finger_joints, close_thresh, reach):
        self.robot_uid = robot_uid
        self.ee_link = ee_link
        self.finger_joints = list(finger_joints)
        self.close_thresh = float(close_thresh)
        self.reach = float(reach)


class _World:
    def __init__(self):
        self.reset()

    def reset(self):
        self.bodies: Dict[int, _Body] = {}
        self.next_uid = 0
        self.dt = 1.0 / 240.0
        self.gravity = (0.0, 0.0, 0.0)
        self.realtime = False
        self._last_wall = time.monotonic()
        self.grasp_rule: Optional[_GraspRule] = None
        self.search_path = ""

    def add(self, body: _Body) -> int:
        self.bodies[body.uid] = body
        return body.uid

    def new_uid(self) -> int:
        uid = self.next_uid
        self.next_uid += 1
        return uid

    # -- stepping ------------------------------------------------------------

    def step(self):
        for body in self.bodies.values():
            self._step_body(body)
        self._apply_grasp_rule()

    def _step_body(self, body: _Body):
        # position-controlled joints slew toward targets at the velocity limit
        for j, target in body.targets.items():
            lo, hi = body.joint_limits[j]
            target = min(max(target, lo), hi)
            dq = target - body.q[j]
            rate = max(body.joint_maxvel[j], 1e-3) * self.dt
            body.q[j] += np.clip(dq, -rate, rate)
        # differential drive: velocity-commanded wheel joints move the base
        if body.wheel_vel and not body.fixed and body.base_mass > 0:
            left = right = None
            for j, vel in body.wheel_vel.items():
                name = body.joint_names[j].lower()
                if "wheel" not in name:
                    continue
                if name.startswith("l") or "left" in name:
                    left = vel
                elif name.startswith("r") or "right" in name:
                    right = vel
            if left is not None and right is not None:
                # fetch-like geometry (envs/pybullet_api.py Fetch constants)
                r, L = 0.0613, 0.372
                v = r * (left + right) / 2.0
                w = r * (right - left) / L
                R = body.base_pose[:3, :3]
                yaw = math.atan2(R[1, 0], R[0, 0])
                yaw += w * self.dt
                body.base_pose[:3, 3] += np.array(
                    [v * math.cos(yaw) * self.dt, v * math.sin(yaw) * self.dt, 0.0]
                )
                body.base_pose[:3, :3] = _rpy_matrix((0, 0, yaw))

    def _apply_grasp_rule(self):
        rule = self.grasp_rule
        if rule is None or rule.robot_uid not in self.bodies:
            return
        robot = self.bodies[rule.robot_uid]
        fingers = float(np.mean([robot.q[j] for j in rule.finger_joints]))
        ee_T = robot.link_transform(rule.ee_link)
        if robot.attached is None and fingers < rule.close_thresh:
            best, best_d = None, rule.reach
            for uid, body in self.bodies.items():
                if uid == rule.robot_uid or body.base_mass <= 0:
                    continue
                d = float(np.linalg.norm(body.base_pose[:3, 3] - ee_T[:3, 3]))
                if d < best_d:
                    best, best_d = uid, d
            if best is not None:
                rel = np.linalg.inv(ee_T) @ self.bodies[best].base_pose
                robot.attached = (best, rule.ee_link, rel)
        elif robot.attached is not None and fingers > 1.5 * rule.close_thresh:
            robot.attached = None
        if robot.attached is not None:
            uid, ee_link, rel = robot.attached
            if uid in self.bodies:
                self.bodies[uid].base_pose = robot.link_transform(ee_link) @ rel

    def maybe_realtime_advance(self):
        if not self.realtime:
            return
        now = time.monotonic()
        steps = int((now - self._last_wall) / self.dt)
        if steps > 0:
            self._last_wall = now
            for _ in range(min(steps, 500)):
                self.step()


_world = _World()


# -- session / world management ----------------------------------------------

def connect(mode=DIRECT, *args, **kwargs) -> int:
    return 0


def disconnect(physicsClientId=None):
    _world.reset()


def resetSimulation(physicsClientId=None):
    _world.reset()


def setGravity(gx, gy, gz, physicsClientId=None):
    _world.gravity = (gx, gy, gz)


def setTimeStep(dt, physicsClientId=None):
    _world.dt = float(dt)


def setPhysicsEngineParameter(**kwargs):
    pass


def setRealTimeSimulation(flag, physicsClientId=None):
    _world.realtime = bool(flag)
    _world._last_wall = time.monotonic()


def setAdditionalSearchPath(path):
    _world.search_path = path


def configureDebugVisualizer(flag=None, enable=None, **kwargs):
    pass


def resetDebugVisualizerCamera(**kwargs):
    pass


def stepSimulation(physicsClientId=None):
    _world.step()


# -- body creation ------------------------------------------------------------

def createCollisionShape(shapeType, **kwargs) -> int:
    return shapeType


def createVisualShape(shapeType, **kwargs) -> int:
    return shapeType


def createMultiBody(
    baseMass=0.0,
    baseCollisionShapeIndex=-1,
    baseVisualShapeIndex=-1,
    basePosition=(0, 0, 0),
    **kwargs,
) -> int:
    from grasptrajopt_tpu.models.mesh import box_mesh

    mesh = None
    shape = baseVisualShapeIndex if baseVisualShapeIndex >= 0 else baseCollisionShapeIndex
    if shape == GEOM_PLANE:
        mesh = box_mesh((20.0, 20.0, 0.001))
    body = _Body.from_primitive(_world.new_uid(), mesh, basePosition, baseMass)
    return _world.add(body)


def loadURDF(
    fileName,
    basePosition=None,
    baseOrientation=None,
    useMaximalCoordinates=0,
    useFixedBase=0,
    flags=0,
    globalScaling=1.0,
    physicsClientId=0,
) -> int:
    pos = basePosition if basePosition is not None else (0.0, 0.0, 0.0)
    orn = baseOrientation if baseOrientation is not None else (0.0, 0.0, 0.0, 1.0)
    path = fileName
    if not os.path.exists(path) and _world.search_path:
        path = os.path.join(_world.search_path, fileName)
    body = _Body.from_urdf(_world.new_uid(), path, pos, orn, bool(useFixedBase))
    return _world.add(body)


# -- joint API -----------------------------------------------------------------

def getNumJoints(uid, physicsClientId=None) -> int:
    return len(_world.bodies[uid].joint_names)


def getJointInfo(uid, index, physicsClientId=None) -> tuple:
    b = _world.bodies[uid]
    lo, hi = b.joint_limits[index]
    return (
        index,
        b.joint_names[index].encode(),
        b.joint_types[index],
        -1,  # qIndex
        -1,  # uIndex
        0,  # flags
        0.0,  # damping
        0.0,  # friction
        lo,
        hi,
        1000.0,  # maxForce
        b.joint_maxvel[index],
        b.link_names[index].encode(),
        tuple(b.joint_axes[index]),
        tuple(b.joint_origins[index][:3, 3]),
        _mat_to_quat_xyzw(b.joint_origins[index][:3, :3]),
        b.joint_parent_link[index],
    )


def resetJointState(uid, index, targetValue, targetVelocity=0.0, physicsClientId=None):
    b = _world.bodies[uid]
    b.q[index] = float(targetValue)
    b.qd[index] = float(targetVelocity)
    b.targets[index] = float(targetValue)


def getJointStates(uid, indices, physicsClientId=None):
    _world.maybe_realtime_advance()
    b = _world.bodies[uid]
    return [(float(b.q[i]), float(b.qd[i]), (0.0,) * 6, 0.0) for i in indices]


def setJointMotorControlArray(
    uid,
    jointIndices,
    controlMode,
    targetPositions=None,
    targetVelocities=None,
    forces=None,
    positionGains=None,
    velocityGains=None,
    physicsClientId=None,
):
    b = _world.bodies[uid]
    if controlMode == POSITION_CONTROL and targetPositions is not None:
        for j, t in zip(jointIndices, targetPositions):
            b.targets[j] = float(t)
    elif controlMode == VELOCITY_CONTROL and targetVelocities is not None:
        for j, v in zip(jointIndices, targetVelocities):
            b.wheel_vel[j] = float(v)


def setJointMotorControl2(
    uid,
    jointIndex,
    controlMode,
    targetPosition=0.0,
    targetVelocity=0.0,
    force=0.0,
    physicsClientId=None,
    **kwargs,
):
    b = _world.bodies[uid]
    if controlMode == POSITION_CONTROL:
        b.targets[jointIndex] = float(targetPosition)
    elif controlMode == VELOCITY_CONTROL:
        b.wheel_vel[jointIndex] = float(targetVelocity)


# -- state queries -------------------------------------------------------------

def getLinkState(uid, linkIndex, computeLinkVelocity=0, computeForwardKinematics=0, physicsClientId=None):
    _world.maybe_realtime_advance()
    T = _world.bodies[uid].link_transform(linkIndex)
    pos = tuple(float(v) for v in T[:3, 3])
    orn = _mat_to_quat_xyzw(T[:3, :3])
    return (pos, orn, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), pos, orn)


def getBasePositionAndOrientation(uid, physicsClientId=None):
    _world.maybe_realtime_advance()
    b = _world.bodies[uid]
    return (
        tuple(float(v) for v in b.base_pose[:3, 3]),
        _mat_to_quat_xyzw(b.base_pose[:3, :3]),
    )


def resetBasePositionAndOrientation(uid, posObj, ornObj, physicsClientId=None):
    b = _world.bodies[uid]
    b.base_pose = np.eye(4)
    b.base_pose[:3, 3] = np.asarray(posObj, dtype=float)
    b.base_pose[:3, :3] = _quat_xyzw_to_mat(ornObj)


def getEulerFromQuaternion(q):
    R = _quat_xyzw_to_mat(q)
    sy = math.hypot(R[0, 0], R[1, 0])
    if sy > 1e-9:
        roll = math.atan2(R[2, 1], R[2, 2])
        pitch = math.atan2(-R[2, 0], sy)
        yaw = math.atan2(R[1, 0], R[0, 0])
    else:
        roll = math.atan2(-R[1, 2], R[1, 1])
        pitch = math.atan2(-R[2, 0], sy)
        yaw = 0.0
    return (roll, pitch, yaw)


def getQuaternionFromEuler(rpy):
    return _mat_to_quat_xyzw(_rpy_matrix(rpy))


def changeDynamics(uid, linkIndex, mass=None, **kwargs):
    if mass is not None and linkIndex == -1:
        _world.bodies[uid].base_mass = float(mass)


def getDynamicsInfo(uid, linkIndex, physicsClientId=None) -> tuple:
    mass = _world.bodies[uid].base_mass if linkIndex == -1 else 0.0
    return (mass, 0.0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), 0.0, 0.0)


# -- camera --------------------------------------------------------------------

def computeProjectionMatrixFOV(fov, aspect, nearVal, farVal):
    f = 1.0 / math.tan(math.radians(fov) / 2.0)
    n, fr = nearVal, farVal
    # column-major GL projection, flattened (matches pybullet)
    return (
        f / aspect, 0.0, 0.0, 0.0,
        0.0, f, 0.0, 0.0,
        0.0, 0.0, (fr + n) / (n - fr), -1.0,
        0.0, 0.0, 2.0 * fr * n / (n - fr), 0.0,
    )


def getCameraImage(
    width,
    height,
    viewMatrix=None,
    projectionMatrix=None,
    physicsClientId=None,
    **kwargs,
):
    from grasptrajopt_tpu.envs.camera import projection_to_intrinsics
    from grasptrajopt_tpu.envs.render import render_depth

    V = np.asarray(viewMatrix, dtype=float).reshape(4, 4).T  # world -> GL cam
    cam_gl = np.linalg.inv(V)
    # GL camera (z backward, y up) -> depth-camera frame (z forward, y down)
    flip = np.eye(4)
    flip[1, 1] = flip[2, 2] = -1.0
    cam_pose = cam_gl @ flip

    P = np.asarray(projectionMatrix, dtype=float).reshape(4, 4).T
    A, B = P[2, 2], P[2, 3]
    near, far = B / (A - 1.0), B / (A + 1.0)
    K = projection_to_intrinsics(projectionMatrix, width, height)

    meshes = []
    for uid, body in _world.bodies.items():
        try:
            visuals = body.visual_meshes()
        except Exception:
            visuals = []
        if not visuals:
            continue
        links = body.link_transforms() if body.joint_names else []
        for li, local, mesh in visuals:
            T = (body.base_pose if li < 0 else links[li]) @ local
            meshes.append((mesh, T, uid))

    depth, ids = render_depth(
        meshes, cam_pose, K, width, height, background_depth=far, znear=near
    )
    depth = np.clip(depth, near, far)
    ndc = (far * (depth - near)) / (depth * (far - near))
    rgba = np.zeros((height, width, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    hit = ids >= 0
    rgba[..., 0][hit] = (37 * (ids[hit] + 1) % 256).astype(np.uint8)
    rgba[..., 1][hit] = (91 * (ids[hit] + 1) % 256).astype(np.uint8)
    rgba[..., 2][hit] = (151 * (ids[hit] + 1) % 256).astype(np.uint8)
    return (width, height, rgba, ndc.astype(np.float32), ids)


# -- inverse kinematics --------------------------------------------------------

def _rotvec_from_mat(R: np.ndarray) -> np.ndarray:
    """Axis-angle vector of a rotation matrix (small-angle safe)."""
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = 0.5 * np.linalg.norm(w)
    c = 0.5 * (np.trace(R) - 1.0)
    angle = math.atan2(s, c)
    if s < 1e-9:
        if c > 0.0:  # ~identity
            return 0.5 * w
        # angle ~ pi: axis from the diagonal
        axis = np.sqrt(np.maximum(0.0, (np.diag(R) + 1.0) / 2.0))
        axis[w < 0] *= -1.0 if np.any(w < 0) else 1.0
        n = np.linalg.norm(axis)
        return angle * (axis / n if n > 0 else np.array([1.0, 0.0, 0.0]))
    return angle * (0.5 * w / s)


def calculateInverseKinematics(
    uid, endEffectorLinkIndex, targetPosition, targetOrientation=None, physicsClientId=None, **kwargs
):
    """Damped-least-squares IK over all movable joints (the real solver's
    role in the retract ladder, pybullet_scenereplica.py:597-623). Position
    only by default; with `targetOrientation` (xyzw quaternion) a 6-dof
    error is solved. Side-effect free like the real engine — the body's
    joint state is restored on return."""
    b = _world.bodies[uid]
    movable = b.movable_joints()
    target = np.asarray(targetPosition, dtype=float)
    R_target = _quat_xyzw_to_mat(targetOrientation) if targetOrientation is not None else None
    q0_saved = b.q.copy()
    q = b.q.copy()
    eps, lam = 1e-5, 1e-3
    nerr = 3 if R_target is None else 6
    try:
        for _ in range(30):
            b.q = q
            T0 = np.asarray(b.link_transform(endEffectorLinkIndex))
            err = target - T0[:3, 3]
            if R_target is not None:
                err = np.concatenate([err, _rotvec_from_mat(R_target @ T0[:3, :3].T)])
            if np.linalg.norm(err) < 1e-4:
                break
            J = np.zeros((nerr, len(movable)))
            for c, j in enumerate(movable):
                b.q = q.copy()
                b.q[j] += eps
                Tj = np.asarray(b.link_transform(endEffectorLinkIndex))
                J[:3, c] = (Tj[:3, 3] - T0[:3, 3]) / eps
                if R_target is not None:
                    # rows consistent with the position block (J = d(pose)/dq,
                    # err = target - pose): -d(rot residual)/dq
                    J[3:, c] = -(
                        _rotvec_from_mat(R_target @ Tj[:3, :3].T)
                        - _rotvec_from_mat(R_target @ T0[:3, :3].T)
                    ) / eps
            b.q = q
            step = J.T @ np.linalg.solve(J @ J.T + lam * np.eye(nerr), err)
            step = np.clip(step, -0.2, 0.2)
            for c, j in enumerate(movable):
                lo, hi = b.joint_limits[j]
                q[j] = min(max(q[j] + step[c], lo), hi)
    finally:
        b.q = q0_saved
    return tuple(float(q[j]) for j in movable)


# -- fake-only helpers ---------------------------------------------------------

def set_grasp_rule(robot_uid, ee_link, finger_joint_indices, close_thresh=0.02, reach=0.25):
    """Attach the nearest free body to the gripper when the fingers close
    (kinematic stand-in for contact physics; see module docstring)."""
    _world.grasp_rule = _GraspRule(robot_uid, ee_link, finger_joint_indices, close_thresh, reach)


def install(force: bool = False) -> bool:
    """Register this module as `pybullet` when the real engine is absent.
    Returns True if the fake is (now) the active pybullet module."""
    import sys

    if "pybullet" in sys.modules and not force:
        return sys.modules["pybullet"] is sys.modules[__name__]
    if not force:
        try:
            import pybullet  # noqa: F401

            return False
        except ImportError:
            pass
    sys.modules["pybullet"] = sys.modules[__name__]
    return True
