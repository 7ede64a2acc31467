"""Runtime-env application shared by the raylet worker pool and the job
manager (reference ``python/ray/_private/runtime_env/``): env_vars merge
(``None`` unsets), working_dir with PYTHONPATH threading, and the
dependency plugins — ``py_modules`` (staged local packages) and ``pip``
(requirements installed into a content-addressed target dir) — backed by
a URI cache (reference ``uri_cache.py``): each unique spec is prepared
ONCE under ``$TMPDIR/ray_tpu_torch/runtime_env/<plugin>/<hash>`` with a
sentinel lock, reused by every worker, and LRU-evicted over a size cap.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

logger = logging.getLogger(__name__)

URI_CACHE_ROOT = os.environ.get(
    "RAY_TPU_TORCH_RUNTIME_ENV_CACHE",
    os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "runtime_env"))
URI_CACHE_MAX_BYTES = int(os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV_CACHE_BYTES",
                                         str(2 << 30)))


def package_root() -> str:
    """Directory containing the ``ray_tpu_torch`` package (the repo root)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------------------- URI cache
def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _evict_lru(plugin_root: str, incoming_hint: int = 0) -> None:
    """Drop least-recently-used cache entries once the plugin's cache
    exceeds the cap (reference uri_cache.py eviction)."""
    try:
        entries = [os.path.join(plugin_root, d) for d in os.listdir(plugin_root)]
    except OSError:
        return
    sized = [(p, _dir_bytes(p), os.path.getmtime(p)) for p in entries if os.path.isdir(p)]
    total = sum(s for _, s, _ in sized) + incoming_hint
    if total <= URI_CACHE_MAX_BYTES:
        return
    for path, size, _mtime in sorted(sized, key=lambda e: e[2]):
        if total <= URI_CACHE_MAX_BYTES:
            break
        shutil.rmtree(path, ignore_errors=True)
        total -= size
        logger.info("runtime_env cache evicted %s (%.1f MB)", path, size / 1e6)


def _prepare_cached(plugin: str, uri_hash: str, build) -> str:
    """Create-once semantics: the first caller builds into a tmp dir and
    renames it in; concurrent callers wait on the ready marker."""
    plugin_root = os.path.join(URI_CACHE_ROOT, plugin)
    os.makedirs(plugin_root, exist_ok=True)
    target = os.path.join(plugin_root, uri_hash)
    if os.path.isdir(target):
        os.utime(target)  # LRU touch
        return target
    tmp = f"{target}.building.{os.getpid()}"
    try:
        os.makedirs(tmp)
    except FileExistsError:
        pass
    else:
        try:
            _evict_lru(plugin_root)
            build(tmp)
            try:
                os.rename(tmp, target)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    deadline = time.monotonic() + 300.0
    while not os.path.isdir(target):
        if time.monotonic() > deadline:
            raise TimeoutError(f"runtime_env {plugin}:{uri_hash} never became ready")
        time.sleep(0.1)
    return target


def _hash_paths(paths: list[str]) -> str:
    """Content hash over module trees so edits produce a fresh URI."""
    h = hashlib.sha1()
    for p in sorted(paths):
        p = os.path.abspath(p)
        h.update(p.encode())
        if os.path.isfile(p):
            h.update(open(p, "rb").read())
            continue
        for root, dirs, files in os.walk(p):
            dirs.sort()
            for f in sorted(files):
                if f.endswith(".pyc"):
                    continue
                fp = os.path.join(root, f)
                h.update(os.path.relpath(fp, p).encode())
                try:
                    h.update(open(fp, "rb").read())
                except OSError:
                    pass
    return h.hexdigest()[:16]


def ensure_py_modules(modules: list[str]) -> str:
    """Stage local module dirs/files into one cached PYTHONPATH entry
    (reference py_modules.py, minus the remote-URI download — single-host
    path semantics, matching working_dir)."""

    def build(tmp: str) -> None:
        for m in modules:
            m = os.path.abspath(m)
            dest = os.path.join(tmp, os.path.basename(m.rstrip("/")))
            if os.path.isdir(m):
                shutil.copytree(m, dest, ignore=shutil.ignore_patterns("__pycache__"))
            else:
                shutil.copy2(m, dest)

    return _prepare_cached("py_modules", _hash_paths(modules), build)


def ensure_pip(requirements: list[str] | dict) -> str:
    """Install requirements ONCE into a cached ``--target`` dir
    (reference pip.py + uri_cache.py). ``--no-build-isolation`` so local
    source packages build offline with the baked setuptools (this
    environment has zero egress; remote packages need a reachable index)."""
    if isinstance(requirements, dict):
        requirements = requirements.get("packages", [])
    reqs = [str(r) for r in requirements]
    uri = hashlib.sha1("\n".join(sorted(reqs)).encode()).hexdigest()[:16]

    def build(tmp: str) -> None:
        cmd = [sys.executable, "-m", "pip", "install", "--quiet",
               "--no-build-isolation", "--target", tmp, *reqs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"pip runtime_env install failed ({' '.join(reqs)}):\n"
                f"{proc.stderr[-2000:]}")

    return _prepare_cached("pip", uri, build)


def apply_runtime_env(env: dict, runtime_env: dict | None) -> str | None:
    """Mutate ``env`` per ``runtime_env``; returns the working_dir to use
    as the subprocess cwd (or None). Does not validate the directory —
    callers decide whether a missing dir warns or fails."""
    renv = runtime_env or {}
    for key, value in (renv.get("env_vars") or {}).items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = str(value)
    extra_paths: list[str] = []
    working_dir = renv.get("working_dir") or None
    if working_dir is not None:
        extra_paths.append(working_dir)
    if renv.get("py_modules"):
        extra_paths.append(ensure_py_modules(list(renv["py_modules"])))
    pip_spec = renv.get("pip") or renv.get("uv")  # uv: same offline semantics
    if pip_spec:
        extra_paths.append(ensure_pip(pip_spec))
    if extra_paths:
        paths = [*extra_paths, package_root()]
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(paths)
    return working_dir


# ------------------------------------------------- interpreter-level plugins


class RuntimeEnvSetupError(RuntimeError):
    """A runtime_env plugin could not be satisfied on this node
    (reference ``_private/runtime_env``'s setup failure surface)."""


def _conda_base() -> str | None:
    import shutil

    exe = os.environ.get("CONDA_EXE") or shutil.which("conda") \
        or shutil.which("micromamba") or shutil.which("mamba")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "info", "--base"], capture_output=True,
                             text=True, timeout=30)
        base = out.stdout.strip().splitlines()[-1].strip() if out.returncode == 0 else ""
    except Exception:
        base = ""
    if not base:
        # micromamba: root prefix env var
        base = os.environ.get("MAMBA_ROOT_PREFIX", "")
    return base or None


def _conda_env_python(spec) -> str:
    """Python interpreter of the requested conda env (reference
    ``runtime_env/conda.py``): a string names an EXISTING env; a dict is
    an environment.yml-style spec created once and cached by hash."""
    base = _conda_base()
    if base is None:
        raise RuntimeEnvSetupError(
            "runtime_env 'conda' requires a conda/micromamba installation "
            "on the node; none found on PATH (and CONDA_EXE unset)")
    if isinstance(spec, str):
        candidates = [os.path.join(base, "envs", spec, "bin", "python")]
        if spec in ("base", ""):
            candidates.insert(0, os.path.join(base, "bin", "python"))
        for c in candidates:
            if os.path.exists(c):
                return c
        raise RuntimeEnvSetupError(
            f"conda env {spec!r} not found under {base}/envs")
    # dict spec: create under the URI cache, keyed by content hash
    import hashlib
    import json
    import shutil as _shutil

    blob = json.dumps(spec, sort_keys=True).encode()
    uri = hashlib.sha1(blob).hexdigest()[:16]

    def build(target: str) -> None:
        yml = os.path.join(target, "environment.yml")
        os.makedirs(target, exist_ok=True)
        with open(yml, "w") as f:
            json.dump(spec, f)
        exe = os.environ.get("CONDA_EXE") or _shutil.which("conda") \
            or _shutil.which("micromamba")
        r = subprocess.run(
            [exe, "env", "create", "--prefix", os.path.join(target, "env"),
             "--file", yml, "--yes"],
            capture_output=True, text=True, timeout=1800)
        if r.returncode != 0:
            raise RuntimeEnvSetupError(
                f"conda env create failed:\n{r.stderr[-2000:]}")

    target = _prepare_cached("conda", uri, build)
    return os.path.join(target, "env", "bin", "python")


def resolve_python_executable(runtime_env: dict | None) -> str | None:
    """Interpreter override for worker processes: ``py_executable``
    (reference ``runtime_env/py_executable.py``) or ``conda`` (reference
    ``runtime_env/conda.py`` — hermetic env, its python). None = the
    raylet's own interpreter."""
    renv = runtime_env or {}
    if renv.get("py_executable"):
        py = renv["py_executable"]
        if not os.path.exists(py):
            raise RuntimeEnvSetupError(f"py_executable {py!r} does not exist")
        return py
    if renv.get("conda"):
        return _conda_env_python(renv["conda"])
    return None


def wrap_worker_command(cmd: list[str], runtime_env: dict | None) -> list[str]:
    """``container``/``image_uri`` plugin (reference
    ``runtime_env/image_uri.py``): run the worker inside a container via
    podman/docker when a runtime exists — host network (the worker must
    reach the raylet/GCS sockets) and /tmp + the repo mounted so the shm
    store arena and source tree resolve. Raises a clear setup error when
    no container runtime is installed."""
    import shutil

    renv = runtime_env or {}
    spec = renv.get("container") or (
        {"image": renv["image_uri"]} if renv.get("image_uri") else None)
    if not spec:
        return cmd
    image = spec.get("image") if isinstance(spec, dict) else spec
    engine = shutil.which("podman") or shutil.which("docker")
    if engine is None:
        raise RuntimeEnvSetupError(
            "runtime_env 'container'/'image_uri' requires podman or docker "
            "on the node; neither found on PATH")
    run_opts = list(spec.get("run_options") or []) if isinstance(spec, dict) else []
    repo = package_root()
    return [engine, "run", "--rm", "--network=host",
            "-v", "/tmp:/tmp", "-v", "/dev/shm:/dev/shm",
            "-v", f"{repo}:{repo}",
            *run_opts, image, *cmd]
