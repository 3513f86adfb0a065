"""Manager templates: config-driven solver lifecycles (+ ROS adapters).

Parity with /root/reference/optas/templates.py: the abstract `Manager`
(config YAML + timed solve, :10-105) and ROS adapters — `ROSManager`
(pub/sub state listener, :108), `ROSController` (reset->solve->publish
loop, :233), `ROSPlanner` (plan + interpolate, :273). ROS classes are
import-gated on rospy (ROS 1); the Manager itself is dependency-free and
drives any of this framework's Solver objects.
"""

from __future__ import annotations

import abc
import time
from typing import Callable, Dict, Optional

import numpy as np


class Manager(abc.ABC):
    def __init__(self, config_filename: Optional[str] = None, record_solver_perf: bool = False):
        self.reset_manager()
        self.config_filename = config_filename
        self.record_solver_perf = record_solver_perf
        self.config = self._load_configuration(config_filename)
        self.solver = self.setup_solver()
        self.solve: Callable = (
            self._solve_and_time if record_solver_perf else self._solve
        )

    def reset_manager(self) -> None:
        self.num_solves = 0
        self.solver_duration = None
        self.solution = None

    @staticmethod
    def _load_configuration(filename: Optional[str]) -> Dict:
        if not filename:
            return {}
        import yaml  # optional dependency: only config files need it

        with open(filename, "rb") as f:
            return yaml.load(f, Loader=yaml.FullLoader)

    def _solve(self) -> None:
        self.solution = self.solver.solve()
        self.num_solves += 1

    def _solve_and_time(self) -> None:
        t0 = time.perf_counter()
        self._solve()
        self.solver_duration = time.perf_counter() - t0

    def get_solver_duration(self) -> Optional[float]:
        return self.solver_duration

    def is_first_solve(self) -> bool:
        return self.num_solves == 0

    @abc.abstractmethod
    def setup_solver(self):
        ...

    @abc.abstractmethod
    def is_ready(self) -> bool:
        ...

    @abc.abstractmethod
    def reset(self) -> None:
        ...

    @abc.abstractmethod
    def get_target(self):
        ...


try:
    import rospy  # noqa: F401

    HAS_ROS = True
except ImportError:
    HAS_ROS = False


if HAS_ROS:

    class ROSManager(Manager):
        """State-listening manager: subscribes to the topics in
        `state_listener` ({topic: msg_type}) and caches the latest
        messages (parity: templates.py:108)."""

        state_listener: Dict[str, type] = {}

        def __init__(self, rosapi, rosver: int = 1, **kwargs):
            self.rosapi = rosapi
            self.rosver = rosver
            self.msgs: Dict[str, object] = {}
            super().__init__(**kwargs)
            for topic, msg_type in self.state_listener.items():
                rospy.Subscriber(topic, msg_type, self._callback, callback_args=topic)

        def _callback(self, msg, topic):
            self.msgs[topic] = msg

        def get_state(self, topic):
            return self.msgs.get(topic)

        def is_ready(self) -> bool:
            return all(t in self.msgs for t in self.state_listener)

    class ROSController(ROSManager):
        """reset -> solve -> publish control loop (parity: templates.py:233)."""

        def __init__(self, rosapi, hz: int = 100, **kwargs):
            super().__init__(rosapi, **kwargs)
            self.hz = hz

        def spin(self, publish: Callable) -> None:
            rate = rospy.Rate(self.hz)
            while not rospy.is_shutdown():
                if self.is_ready():
                    self.reset()
                    self.solve()
                    publish(np.asarray(self.get_target()))
                rate.sleep()

    class ROSPlanner(ROSManager):
        """One-shot plan + time-interpolation (parity: templates.py:273)."""

        def plan(self):
            self.reset()
            self.solve()
            return self.get_target()

        @staticmethod
        def interpolate(traj, duration: float, **kwargs):
            from scipy import interpolate as si

            traj = np.asarray(traj)
            t = np.linspace(0, duration, traj.shape[1])
            return si.interp1d(t, traj, axis=1, **kwargs)
