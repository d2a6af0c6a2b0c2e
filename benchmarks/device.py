"""What the benchmark scripts share: the device they ran on, and timing.

Every result names the card it ran on; a measurement that finds no GPU
stops instead of timing the CPU. Times fence on device completion with
jax.block_until_ready.
"""

from __future__ import annotations

import subprocess
import sys
import time


def require_gpu() -> dict:
    """{'platform', 'kind', 'count', 'card'} of the GPU this process
    drives; exits with code 2 when JAX finds no GPU. Prints the card's
    name and power limit (nvidia-smi) to stderr."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.stderr.write(f"no GPU: jax found {d.platform} devices\n")
        sys.exit(2)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        card = f"nvidia-smi unavailable: {e}"
    sys.stderr.write(f"# card: {card}\n")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card}


def best_time(fn, iters: int, rounds: int = 3) -> float:
    """Best over `rounds` of the mean seconds per call of `fn(i)`, `iters`
    calls per round, fenced once per round on device completion. The
    first call (compilation) is not timed."""
    import jax

    jax.block_until_ready(fn(0))
    best = float("inf")
    for r in range(rounds):
        t0 = time.perf_counter()
        for i in range(iters):
            out = fn(r * iters + i)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best
