"""Job submission on a port cluster (``ray_tpu_torch.job``), on the CPU:
``tests/test_job.py``'s success, failure, ``env_vars`` and
``working_dir``, a driver that connects through
``RAY_TPU_TORCH_ADDRESS`` and runs a task, and stop; and the
``JobInfo`` fields and ``JobStatus`` values against the JAX package's.
One module cluster: each job starts a subprocess."""

import dataclasses
import os
import textwrap
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu.job import JobInfo as JaxJobInfo
from ray_tpu.job import JobStatus as JaxJobStatus
from ray_tpu_torch.job import JobInfo, JobStatus, JobSubmissionClient
from ray_tpu_torch.job import job_manager


@pytest.fixture(scope="module")
def client():
    # tests/conftest.py shuts down only ray_tpu's cluster, so this module
    # shuts its own down.
    rt.init(num_cpus=4)
    try:
        yield JobSubmissionClient()
    finally:
        rt.shutdown()


def test_job_succeeds_and_logs(client):
    jid = client.submit_job(entrypoint="echo hello-from-job && echo line2")
    assert client.wait_until_terminal(jid, timeout=60) == JobStatus.SUCCEEDED
    logs = client.get_job_logs(jid)
    assert "hello-from-job" in logs and "line2" in logs
    jobs = {j.submission_id: j for j in client.list_jobs()}
    assert jobs[jid].status == JobStatus.SUCCEEDED
    assert jobs[jid].end_time >= jobs[jid].start_time > 0


def test_job_failure_reported(client):
    jid = client.submit_job(entrypoint="python -c 'import sys; sys.exit(3)'")
    assert client.wait_until_terminal(jid, timeout=60) == JobStatus.FAILED
    assert "code 3" in client.get_job_info(jid).message


def test_job_env_vars_and_working_dir(client, tmp_path):
    (tmp_path / "helper_mod.py").write_text("VALUE = 'from-working-dir'\n")
    (tmp_path / "main.py").write_text(textwrap.dedent("""
        import os, helper_mod
        print("env:", os.environ["MY_JOB_VAR"])
        print("mod:", helper_mod.VALUE)
        print("job:", os.environ["RAY_TPU_TORCH_JOB_ID"])
        """))
    jid = client.submit_job(
        entrypoint="python main.py",
        runtime_env={"working_dir": str(tmp_path),
                     "env_vars": {"MY_JOB_VAR": "42"}})
    assert client.wait_until_terminal(jid, timeout=60) == JobStatus.SUCCEEDED
    logs = client.get_job_logs(jid)
    assert "env: 42" in logs and "mod: from-working-dir" in logs
    assert f"job: {jid}" in logs


def test_job_driver_connects_to_cluster(client, tmp_path):
    """The entrypoint is a driver of this cluster: it connects through
    ``RAY_TPU_TORCH_ADDRESS`` and runs a task on it."""
    (tmp_path / "driver.py").write_text(textwrap.dedent("""
        import os
        import ray_tpu_torch as rt
        rt.init()  # picks up RAY_TPU_TORCH_ADDRESS
        @rt.remote
        def f():
            return "task-ran-on-cluster"
        print(rt.get(f.remote(), timeout=60))
        print("address:", os.environ["RAY_TPU_TORCH_ADDRESS"])
        print("ray_tpu_address:", os.environ.get("RAY_TPU_ADDRESS"))
        rt.shutdown()
        """))
    jid = client.submit_job(entrypoint="python driver.py",
                            runtime_env={"working_dir": str(tmp_path)})
    status = client.wait_until_terminal(jid, timeout=120)
    logs = client.get_job_logs(jid)
    assert status == JobStatus.SUCCEEDED, logs
    assert "task-ran-on-cluster" in logs
    from ray_tpu_torch.core.worker import global_worker

    assert f"address: {global_worker().gcs_address}" in logs


def _pids_running(cmdline: str) -> list:
    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                if f.read().replace(b"\0", b" ").strip() == cmdline.encode():
                    out.append(int(entry))
        except (OSError, ValueError):
            pass
    return out


def test_job_stop(client):
    """``stop_job`` ends the entrypoint and what its shell started: the
    shell forks ``sleep`` as a child, which must not outlive the job."""
    sleep = f"sleep {600 + os.getpid() % 1000}.5"
    jid = client.submit_job(entrypoint=f"{sleep}; echo after")
    deadline = time.monotonic() + 30
    while client.get_job_status(jid) == JobStatus.PENDING or \
            not _pids_running(sleep):
        assert time.monotonic() < deadline
        time.sleep(0.1)
    assert client.stop_job(jid)
    assert client.wait_until_terminal(jid, timeout=30) == JobStatus.STOPPED
    assert not client.stop_job(jid)  # already terminal
    deadline = time.monotonic() + 10
    while _pids_running(sleep) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _pids_running(sleep)


def test_job_info_and_status_equal_jax():
    fields = [(f.name, f.type, f.default) for f in dataclasses.fields(JobInfo)
              if f.default is not dataclasses.MISSING]
    want = [(f.name, f.type, f.default)
            for f in dataclasses.fields(JaxJobInfo)
            if f.default is not dataclasses.MISSING]
    assert fields == want
    assert [f.name for f in dataclasses.fields(JobInfo)] == \
        [f.name for f in dataclasses.fields(JaxJobInfo)]
    values = {k: v for k, v in vars(JobStatus).items() if k.isupper()}
    assert values == {k: v for k, v in vars(JaxJobStatus).items()
                      if k.isupper()}
    assert values["TERMINAL"] == ("SUCCEEDED", "FAILED", "STOPPED")


def test_names_are_the_ports(client):
    from ray_tpu.job import job_manager as jax_job_manager

    assert job_manager.JOB_MANAGER_NAME != jax_job_manager.JOB_MANAGER_NAME
    assert rt.get_actor(job_manager.JOB_MANAGER_NAME) is not None
    import tempfile

    mgr = rt.get_actor(job_manager.JOB_MANAGER_NAME)
    jid = client.submit_job(entrypoint="true")
    client.wait_until_terminal(jid, timeout=30)
    assert rt.get(mgr.logs.remote(jid), timeout=30) == ""
    assert os.path.exists(os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "jobs", f"{jid}.log"))
