"""Run a snippet under a forced multi-device CPU topology in a background
subprocess (``_subproc.run_multidevice`` without the wait), so that the
port-only tests of a module run while the reference computes."""
import os
import subprocess
import sys

from _subproc import SRC


class JaxInBackground:
    def __init__(self, code: str, n_devices: int = 4, timeout: int = 900):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={n_devices}")
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)

    def result(self) -> str:
        """The snippet's standard output, once it has exited 0."""
        out, err = self.proc.communicate(timeout=self.timeout)
        assert self.proc.returncode == 0, (
            f"subprocess failed:\n{out}\n{err}")
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()
