"""Two-level control plane (paper §III-D, Fig. 2).

V-BOINC's host client controls BOTH the VM process (``controlvm``) and the
BOINC client *inside* the VM (``boinccmd`` wrapped through ``guestcontrol``).
The analogue: a Coordinator ("V-BOINC server") talks to per-pod
HostSupervisors ("host client"), each of which forwards wrapped command
envelopes to its CapsuleRuntime ("inner client").  Commands that target the
runtime itself (suspend/resume of the *capsule*) are distinct from commands
that target the workload inside it (suspend/resume of the *job*) — exactly
the paper's ``controlvm`` vs ``guestcontrol`` split.

All state machines are real; transport is in-process (RPC on a cluster).
Heartbeat timeouts replace the paper's VM-process watching for failure
detection, feeding the scheduler's re-issue path.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class RuntimeState(enum.Enum):
    CREATED = "created"
    BOOTING = "booting"          # compile/restore in progress
    RUNNING = "running"
    SUSPENDED = "suspended"
    HALTED = "halted"
    FAILED = "failed"


class JobState(enum.Enum):
    IDLE = "idle"
    RUNNING = "running"
    SUSPENDED = "suspended"
    NO_MORE_WORK = "no_more_work"


# boinccmd verbs (paper §III-D) + controlvm verbs
GUEST_COMMANDS = {"suspend", "resume", "reset", "detach", "update",
                  "nomorework", "allowmorework"}
VM_COMMANDS = {"startvm", "poweroff", "pause", "unpause", "snapshot"}


@dataclass
class Envelope:
    """A wrapped command, as the middleware wraps boinccmd in guestcontrol."""
    target: str                  # "vm" | "guest"
    verb: str
    args: dict = field(default_factory=dict)
    issued: float = field(default_factory=time.time)


class CapsuleRuntime:
    """The 'inner BOINC client': runs jobs inside the capsule."""

    def __init__(self, name: str, *, on_snapshot: Optional[Callable] = None):
        self.name = name
        self.state = RuntimeState.CREATED
        self.job_state = JobState.IDLE
        self.on_snapshot = on_snapshot
        self.log: List[str] = []
        self.last_heartbeat = time.time()
        self.completed_units: List[Any] = []

    def _note(self, msg: str) -> None:
        self.log.append(msg)

    def boot(self) -> None:
        assert self.state in (RuntimeState.CREATED, RuntimeState.HALTED)
        self.state = RuntimeState.BOOTING
        self.state = RuntimeState.RUNNING
        self.job_state = JobState.RUNNING
        self._note("booted")

    def heartbeat(self) -> None:
        self.last_heartbeat = time.time()

    def handle(self, env: Envelope) -> dict:
        self.heartbeat()
        if env.target == "vm":
            return self._handle_vm(env)
        return self._handle_guest(env)

    def _handle_vm(self, env: Envelope) -> dict:
        if env.verb == "startvm":
            self.boot()
        elif env.verb == "poweroff":
            self.state = RuntimeState.HALTED
            self.job_state = JobState.IDLE
        elif env.verb == "pause":
            if self.state is RuntimeState.RUNNING:
                self.state = RuntimeState.SUSPENDED
        elif env.verb == "unpause":
            if self.state is RuntimeState.SUSPENDED:
                self.state = RuntimeState.RUNNING
        elif env.verb == "snapshot":
            if self.on_snapshot is not None:
                info = self.on_snapshot()
                self._note(f"snapshot {getattr(info, 'snapshot_id', '?')}")
                return {"ok": True, "snapshot": info}
        else:
            return {"ok": False, "error": f"unknown vm verb {env.verb}"}
        self._note(f"vm:{env.verb} -> {self.state.value}")
        return {"ok": True, "state": self.state.value}

    def _handle_guest(self, env: Envelope) -> dict:
        if self.state is not RuntimeState.RUNNING:
            # guestcontrol needs a live VM (paper: commands are executed
            # on the virtual machine via Guest Additions)
            return {"ok": False, "error": "capsule not running"}
        if env.verb == "suspend":
            self.job_state = JobState.SUSPENDED
        elif env.verb == "resume":
            self.job_state = JobState.RUNNING
        elif env.verb == "nomorework":
            self.job_state = JobState.NO_MORE_WORK
        elif env.verb == "allowmorework":
            self.job_state = JobState.RUNNING
        elif env.verb == "reset":
            self.job_state = JobState.IDLE
            self.completed_units.clear()
        elif env.verb in ("detach", "update"):
            pass  # project-attachment bookkeeping
        else:
            return {"ok": False, "error": f"unknown guest verb {env.verb}"}
        self._note(f"guest:{env.verb} -> {self.job_state.value}")
        return {"ok": True, "job_state": self.job_state.value}

    @property
    def accepting_work(self) -> bool:
        return (self.state is RuntimeState.RUNNING
                and self.job_state is JobState.RUNNING)


class HostSupervisor:
    """The 'host BOINC client': owns one capsule runtime, wraps commands."""

    def __init__(self, host_id: str, runtime: CapsuleRuntime,
                 heartbeat_timeout: float = 5.0):
        self.host_id = host_id
        self.runtime = runtime
        self.heartbeat_timeout = heartbeat_timeout

    def control_vm(self, verb: str, **args) -> dict:
        if verb not in VM_COMMANDS:
            return {"ok": False, "error": f"not a vm verb: {verb}"}
        return self.runtime.handle(Envelope("vm", verb, args))

    def boinccmd(self, verb: str, **args) -> dict:
        """Wrap a boinccmd in a guestcontrol envelope (paper Fig. 2)."""
        if verb not in GUEST_COMMANDS:
            return {"ok": False, "error": f"not a boinccmd verb: {verb}"}
        return self.runtime.handle(Envelope("guest", verb, args))

    def healthy(self, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.time()
        if self.runtime.state is RuntimeState.FAILED:
            return False
        return (now - self.runtime.last_heartbeat) < self.heartbeat_timeout

    def status(self) -> dict:
        return {"host": self.host_id,
                "vm": self.runtime.state.value,
                "job": self.runtime.job_state.value,
                "healthy": self.healthy()}


class Coordinator:
    """The 'V-BOINC server' view of the fleet: registry + failure detection."""

    def __init__(self):
        self.hosts: Dict[str, HostSupervisor] = {}

    def register(self, sup: HostSupervisor) -> None:
        self.hosts[sup.host_id] = sup

    def deregister(self, host_id: str) -> None:
        self.hosts.pop(host_id, None)

    def broadcast(self, target: str, verb: str, **args) -> dict:
        out = {}
        for hid, sup in self.hosts.items():
            fn = sup.control_vm if target == "vm" else sup.boinccmd
            out[hid] = fn(verb, **args)
        return out

    def failed_hosts(self, now: Optional[float] = None) -> list[str]:
        return [hid for hid, sup in self.hosts.items()
                if not sup.healthy(now)]

    def fleet_status(self) -> list[dict]:
        return [sup.status() for sup in self.hosts.values()]
