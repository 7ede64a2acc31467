"""Job submission: run entrypoint scripts as managed cluster drivers.

Equivalent of the reference's job submission stack
(``dashboard/modules/job/job_manager.py``,
``dashboard/modules/job/sdk.py`` JobSubmissionClient): a job is a shell
entrypoint spawned as a driver subprocess with ``RAY_TPU_TORCH_ADDRESS``
pointing at the running cluster, tracked through a
PENDING/RUNNING/SUCCEEDED/FAILED/STOPPED FSM with captured logs.
"""

from .job_manager import JobInfo, JobStatus, JobSubmissionClient

__all__ = ["JobInfo", "JobStatus", "JobSubmissionClient"]
