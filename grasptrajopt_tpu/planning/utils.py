"""Planning utilities: configs, waypoint interpolation, default poses.

Parity targets: /root/reference/gto/utils.py (load_yaml :15, rotZ :24,
default_pose :36, interpolate_waypoints :63-82).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import jax.numpy as jnp


def get_root_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..")


def get_data_dir() -> str:
    """Robot asset tree (URDFs, meshes, configs, grasps).

    Defaults to the reference checkout's data tree; override with
    GTO_DATA_DIR for a standalone deployment.
    """
    return os.environ.get("GTO_DATA_DIR", "/root/reference/data")


def load_yaml(file_path):
    if isinstance(file_path, str):
        import yaml  # optional dependency: only config files need it

        with open(file_path) as f:
            return yaml.load(f, Loader=yaml.Loader)
    return file_path


def load_robot_config(robot_name: str, data_dir: Optional[str] = None) -> dict:
    data_dir = data_dir or get_data_dir()
    path = os.path.join(data_dir, "configs", f"{robot_name}.yaml")
    return load_yaml(path)["robot_cfg"]


def rotZ(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def default_pose(robot_model) -> np.ndarray:
    """Canonical start configurations (parity: gto/utils.py:36-60)."""
    q = np.zeros(robot_model.ndof, dtype=np.float32)
    if robot_model.name == "fetch":
        q[2] = 0.4
        q[3] = 0.009195
        q[4] = 0.908270
        q[[5, 6, 7, 8, 9, 10, 11]] = [1.32, 0.7, 0.0, -2.0, 0.0, -0.57, 0.0]
    elif robot_model.name == "panda":
        q = np.array([0.0, -1.285, 0, -2.356, 0.0, 1.571, 0.785, 0.0, 0.0], dtype=np.float32)
    return q


def interpolate_waypoints(waypoints: np.ndarray, n: int, m: int, mode: str = "cubic") -> np.ndarray:
    """Interpolate a (W, m) waypoint stack to (n, m) samples.

    Parity: gto/utils.py:63-82 — samples at t = linspace(0, 1, n+2)[1:-1]
    with a *clamped* cubic spline (zero end velocities) or linear
    interpolation. For the planners' 2-waypoint case the clamped cubic is
    the Hermite smoothstep, computed in closed form.
    """
    waypoints = np.asarray(waypoints, dtype=np.float64)
    t = np.linspace(0.0, 1.0, n + 2)[1:-1]
    if waypoints.shape[0] == 2 and mode == "cubic":
        s = 3.0 * t**2 - 2.0 * t**3
        return waypoints[0][None, :] + s[:, None] * (waypoints[1] - waypoints[0])[None, :]
    x = np.linspace(0.0, 1.0, waypoints.shape[0])
    data = np.zeros((n, m))
    from scipy import interpolate as si

    for i in range(waypoints.shape[1]):
        if mode == "linear":
            f = si.interp1d(x, waypoints[:, i], "linear")
        else:
            f = si.CubicSpline(x, waypoints[:, i], bc_type="clamped")
        data[:, i] = f(t)
    return data


def interpolate_waypoints_jnp(qc, qs, n: int):
    """Device version of the 2-waypoint clamped cubic (smoothstep) used for
    warm starts — vmappable over batches of (qc, qs)."""
    t = jnp.linspace(0.0, 1.0, n + 2)[1:-1].astype(qc.dtype)
    s = 3.0 * t**2 - 2.0 * t**3
    return qc[None, :] + s[:, None] * (qs - qc)[None, :]
