"""The NVIDIA card a run is on: its identity line and the GPU check that the
card-only entry points (``chip_smoke.py``, ``bench.py``) start with."""

import subprocess


def card_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else (
        f"nvidia-smi failed (rc={out.returncode})")


def require_gpu(tool):
    """JAX's first device, or SystemExit when it is not a GPU: there is no
    CPU fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{tool}: JAX's first device is {dev.platform!r}, not a GPU"
        )
    return dev
