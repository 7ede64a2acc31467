"""Job manager actor + submission client.

Reference: ``dashboard/modules/job/job_manager.py`` (JobManager.submit_job
spawns a JobSupervisor that runs the entrypoint as a subprocess and
polls it to a terminal state) and ``job/common.py`` (JobStatus FSM).
Redesign: one detached named actor supervises all jobs (our actors are
cheap single-process asyncio, no per-job supervisor actor needed);
drivers attach to the cluster through ``RAY_TPU_TORCH_ADDRESS``. The
manager actor's name, the log directory and the environment carry the
port's names, so a port cluster's jobs never meet a ``ray_tpu``
cluster's.
"""

from __future__ import annotations

import os
import re
import shlex
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field

from ..core import api as ray

JOB_MANAGER_NAME = "_TORCH_JOB_MANAGER"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    runtime_env: dict = field(default_factory=dict)


class _JobManagerActor:
    def __init__(self, gcs_address: str, log_dir: str | None = None):
        self.gcs_address = gcs_address
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "jobs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jobs: dict[str, JobInfo] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, runtime_env: dict | None = None,
               submission_id: str | None = None) -> str:
        if submission_id is not None and not re.fullmatch(r"[A-Za-z0-9._-]+", submission_id):
            raise ValueError(
                f"invalid submission_id {submission_id!r}: only letters, digits, "
                "'.', '_' and '-' are allowed (it names the log file)"
            )
        jid = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if jid in self._jobs:
                raise ValueError(f"job {jid} already exists")
            info = JobInfo(jid, entrypoint, runtime_env=runtime_env or {})
            self._jobs[jid] = info

        from ..core.runtime_env import apply_runtime_env

        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self.gcs_address
        env["RAY_TPU_TORCH_JOB_ID"] = jid
        cwd = apply_runtime_env(env, runtime_env)
        if cwd is not None and not os.path.isdir(cwd):
            info.status, info.message = JobStatus.FAILED, f"working_dir {cwd} not found"
            return jid

        log_path = os.path.join(self.log_dir, f"{jid}.log")
        try:
            proc = subprocess.Popen(
                entrypoint if isinstance(entrypoint, str) else shlex.join(entrypoint),
                shell=True,
                cwd=cwd,
                env=env,
                stdout=open(log_path, "wb"),
                stderr=subprocess.STDOUT,
                # Its own process group, so that stop() reaches what the
                # shell started too (the reference's JobSupervisor does
                # the same).
                start_new_session=True,
            )
        except OSError as e:
            info.status, info.message = JobStatus.FAILED, str(e)
            return jid
        with self._lock:
            if info.status == JobStatus.STOPPED:
                # stop() won the race while we were spawning: honor it.
                _signal_group(proc, signal.SIGTERM)
                info.end_time = time.time()
                return jid
            info.status = JobStatus.RUNNING
            info.start_time = time.time()
            self._procs[jid] = proc
        threading.Thread(target=self._supervise, args=(jid, proc), daemon=True).start()
        return jid

    def _supervise(self, jid: str, proc: subprocess.Popen) -> None:
        code = proc.wait()
        with self._lock:
            info = self._jobs[jid]
            self._procs.pop(jid, None)
            if info.status == JobStatus.STOPPED:
                pass  # stop_job already finalized it
            elif code == 0:
                info.status = JobStatus.SUCCEEDED
            else:
                info.status = JobStatus.FAILED
                info.message = f"entrypoint exited with code {code}"
            info.end_time = time.time()

    def stop(self, jid: str) -> bool:
        with self._lock:
            info = self._jobs.get(jid)
            proc = self._procs.get(jid)
            if info is None or info.status in JobStatus.TERMINAL:
                return False
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
        if proc is not None:
            _signal_group(proc, signal.SIGTERM)
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
            # Whatever the entrypoint started and left behind goes too.
            _signal_group(proc, signal.SIGKILL)
        return True

    def status(self, jid: str) -> dict | None:
        with self._lock:
            info = self._jobs.get(jid)
            return asdict(info) if info else None

    def list(self) -> list[dict]:
        with self._lock:
            return [asdict(i) for i in self._jobs.values()]

    def logs(self, jid: str) -> str:
        path = os.path.join(self.log_dir, f"{jid}.log")
        try:
            with open(path, "rb") as f:
                return f.read().decode("utf-8", errors="replace")
        except OSError:
            return ""


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """Send ``sig`` to the entrypoint's process group: the shell and every
    process it started."""
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass  # the whole group has exited


class JobSubmissionClient:
    """Reference ``dashboard/modules/job/sdk.py``: submit/list/stop/logs
    against the (auto-created) job manager actor."""

    def __init__(self):
        try:
            self._mgr = ray.get_actor(JOB_MANAGER_NAME)
        except ValueError:
            from ..core.worker import global_worker

            gcs_address = global_worker().gcs_address
            self._mgr = ray.remote(_JobManagerActor).options(
                name=JOB_MANAGER_NAME, lifetime="detached", num_cpus=0,
                max_concurrency=16,
            ).remote(gcs_address)
            ray.get(self._mgr.list.remote(), timeout=60)  # wait until live

    def submit_job(self, *, entrypoint: str, runtime_env: dict | None = None,
                   submission_id: str | None = None) -> str:
        return ray.get(
            self._mgr.submit.remote(entrypoint, runtime_env, submission_id), timeout=60
        )

    def get_job_status(self, submission_id: str) -> str:
        info = ray.get(self._mgr.status.remote(submission_id), timeout=60)
        if info is None:
            raise ValueError(f"no such job: {submission_id}")
        return info["status"]

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = ray.get(self._mgr.status.remote(submission_id), timeout=60)
        if info is None:
            raise ValueError(f"no such job: {submission_id}")
        return JobInfo(**info)

    def list_jobs(self) -> list[JobInfo]:
        return [JobInfo(**i) for i in ray.get(self._mgr.list.remote(), timeout=60)]

    def get_job_logs(self, submission_id: str) -> str:
        return ray.get(self._mgr.logs.remote(submission_id), timeout=60)

    def stop_job(self, submission_id: str) -> bool:
        return ray.get(self._mgr.stop.remote(submission_id), timeout=60)

    def wait_until_terminal(self, submission_id: str, timeout: float = 120.0) -> str:
        deadline = time.monotonic() + timeout
        while True:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(f"job {submission_id} still {status} after {timeout}s")
            time.sleep(0.2)
