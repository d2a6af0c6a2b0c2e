"""Serving soak test: long-run stability of the production service.

VERDICT r4 item 8: the service has endpoint/batching tests and a
throughput probe (serve_load.py) but no long-run evidence. This drives
N clients x mixed request kinds (render f32/u8/binary-PNG, region
renders, animations, .mmxa artifact renders, varying sizes and params)
at an in-process RenderService + HTTP stack for SOAK_S seconds on CPU
and asserts the three long-lived-service invariants:

  1. flat RSS: median of the last quarter's samples vs the second
     quarter's (the first quarter is compile/allocator warmup) grows
     < 5% and < 40 MB — no per-request leak;
  2. bounded program caches: the compiled-program count (service
     filter cache + per-renderer jit programs, reported by
     /stats "programs" and measured directly as the live jit-cache
     sizes) PLATEAUS — end count == count at the 25% mark (the request
     vocabulary is finite, so programs must stop growing once every
     (filter,size,options,bucket) combination has been seen);
  3. zero dropped futures: every issued request returns (ok or a
     readable error); ok == issued and service stats errors == 0.

This models the reference's in-process lifetime: the GIMP plugin lives
inside a long-running GIMP process and must not leak per-invocation
(`mathmap.c` plugin lifecycle [unverified - mount empty]).

Run (CPU):  JAX_PLATFORMS=cpu python benchmarks/serve_soak.py
Options:    SOAK_S=600 SOAK_CLIENTS=8 (defaults; SOAK_S=60 for a smoke)
Exit code 0 + one JSON line on stdout iff all invariants held.
Recorded results: docs/SERVING.md "Soak" section.
"""

from __future__ import annotations

import base64
import io
import json
import os
import pathlib
import sys
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def live_program_count(svc) -> int:
    """Compiled-program census across every cache layer: the service's
    filter cache plus each cached Filter's renderer jit programs."""
    n = 0
    with svc._lock:
        filters = list(svc._filters.values())
    for f in filters:
        n += len(getattr(f, "_jit_cache", {}) or {})
    for art in svc.artifacts.values():
        n += len(getattr(art, "_exp_batch", {}) or {})
    return n + len(filters)


def main():
    duration = float(os.environ.get("SOAK_S", "600"))
    n_clients = int(os.environ.get("SOAK_CLIENTS", "8"))

    from mathmap_tpu.serve import RenderService, serve

    svc = RenderService(max_batch=16, window_ms=3.0)
    httpd, svc = serve(port=0, service=svc, block=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    # one .mmxa artifact in the mix (precompiled-program serving path)
    import tempfile

    import mathmap_tpu as mm
    from mathmap_tpu.generators.artifact import export_artifact

    art_dir = tempfile.mkdtemp(prefix="soak_art_")
    f_art = mm.compile(
        "filter tinted (image in, float gain: 0-2 (1)) in(xy) * gain end")
    export_artifact(f_art, os.path.join(art_dir, "tinted.mmxa"), 96, 96,
                    params={"gain": 1.0})
    svc.load_artifacts(art_dir)

    from PIL import Image

    rng = np.random.RandomState(11)

    def png_b64(h, w):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    imgs = {(96, 96): png_b64(96, 96), (128, 160): png_b64(128, 160)}

    def post(path, obj, binary=False, timeout=300):
        req = urllib.request.Request(
            base + path, json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            data = r.read()
            return None if binary else json.loads(data)

    # FIXED request vocabulary (finite program space — invariant 2's
    # premise): kinds cycle per client-iteration; params/t vary VALUES
    # only (values are not part of a jit signature; name sets are).
    def request(ci: int, k: int):
        kind = (ci + k) % 6
        t = 0.01 * ((ci * 977 + k * 131) % 100)
        if kind == 0:    # plain render, f32-raw response
            post("/render", {"filter": "twirl", "width": 160, "height": 128,
                             "t": t, "params": {"angle": 1.0 + 0.01 * k},
                             "inputs": [imgs[(128, 160)]], "format": "raw"})
        elif kind == 1:  # binary PNG response, second size
            post("/render", {"filter": "ripple", "width": 96, "height": 96,
                             "t": t, "inputs": [imgs[(96, 96)]],
                             "binary": True}, binary=True)
        elif kind == 2:  # region (selection) render — options-signature kind
            post("/render", {"filter": "twirl", "width": 160, "height": 128,
                             "t": t, "params": {"angle": 2.0 + 0.01 * k},
                             "region": [8, 8, 64, 48],
                             "inputs": [imgs[(128, 160)]], "format": "raw"})
        elif kind == 3:  # generative render, no inputs
            post("/render", {"filter": "moire", "width": 96,
                             "height": 96, "t": t, "format": "raw"})
        elif kind == 4:  # animation (solo-dispatch path)
            post("/animate", {"filter": "ripple", "width": 96, "height": 96,
                              "num_frames": 3, "inputs": [imgs[(96, 96)]],
                              "format": "raw"})
        else:            # precompiled artifact
            post("/render", {"artifact": "tinted", "t": t,
                             "params": {"gain": 1.0 + 0.001 * (k % 7)},
                             "inputs": [imgs[(96, 96)]], "format": "raw"})

    issued = [0] * n_clients
    ok = [0] * n_clients
    errors: list = []
    lock = threading.Lock()
    deadline = time.monotonic() + duration

    def client(ci):
        k = 0
        while time.monotonic() < deadline:
            issued[ci] += 1
            try:
                request(ci, k)
                ok[ci] += 1
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"client{ci} iter{k}: {e}")
            k += 1

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.monotonic()
    for th in threads:
        th.start()

    samples = []  # (elapsed_s, rss_kb, programs)
    while any(th.is_alive() for th in threads):
        time.sleep(min(10.0, max(1.0, duration / 40)))
        samples.append((round(time.monotonic() - t0, 1), rss_kb(),
                        live_program_count(svc)))
        s = samples[-1]
        print(f"# t={s[0]:7.1f}s rss={s[1] / 1024:7.1f}MB programs={s[2]}"
              f" jobs={svc.stats['jobs']}", file=sys.stderr, flush=True)
    for th in threads:
        th.join()
    wall = time.monotonic() - t0

    stats = svc.snapshot()
    n_issued, n_ok = sum(issued), sum(ok)

    # ---- invariants ----
    qlen = max(1, len(samples) // 4)
    q2 = [s[1] for s in samples[qlen:2 * qlen]] or [samples[-1][1]]
    q4 = [s[1] for s in samples[-qlen:]]
    rss_q2, rss_q4 = float(np.median(q2)), float(np.median(q4))
    rss_growth_mb = (rss_q4 - rss_q2) / 1024
    rss_flat = (rss_q4 <= rss_q2 * 1.05) and (rss_growth_mb < 40)

    prog_25 = samples[qlen - 1][2] if len(samples) >= qlen else samples[-1][2]
    prog_end = samples[-1][2]
    programs_plateaued = prog_end == prog_25

    no_drops = (n_ok == n_issued) and (stats["errors"] == 0) and not errors

    out = {
        "metric": "serve_soak", "duration_s": round(wall, 1),
        "clients": n_clients, "requests": n_issued, "ok": n_ok,
        "req_per_s": round(n_ok / wall, 1),
        "dispatches": stats["dispatches"],
        "batch_hist": stats["batch_hist"],
        "mean_latency_ms": stats.get("mean_latency_ms"),
        "rss_mb_q2": round(rss_q2 / 1024, 1),
        "rss_mb_end": round(rss_q4 / 1024, 1),
        "rss_growth_mb": round(rss_growth_mb, 1),
        "programs_at_25pct": prog_25, "programs_end": prog_end,
        "rss_flat": rss_flat, "programs_plateaued": programs_plateaued,
        "zero_drops": no_drops,
        "passed": bool(rss_flat and programs_plateaued and no_drops),
    }
    print(json.dumps(out))
    if errors:
        print("# first error:", errors[0][:300], file=sys.stderr)
    httpd.shutdown()
    svc.shutdown()
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
