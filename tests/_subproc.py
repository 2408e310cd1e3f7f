"""Run a test body in a fresh Python subprocess.

Workaround for a jaxlib XLA:CPU bug on this host: after many in-process
kernel compilations, a subsequent compile segfaults
(backend_compile_and_load).  Compile-heavy end-to-end tests therefore run in
a fresh interpreter; results come back as one JSON line on stdout.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

_REPO = str(pathlib.Path(__file__).resolve().parents[1])


def run_python_json(code: str, timeout: int = 3600) -> dict:
    """Execute `code` (which must print exactly one JSON line prefixed
    RESULT:) in a fresh interpreter on the CPU backend."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=_REPO,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(
        f"subprocess produced no RESULT line (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
