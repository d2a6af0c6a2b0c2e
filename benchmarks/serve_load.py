"""Serving load test: end-to-end throughput of the production service.

Fires N client threads x M requests each at an in-process RenderService
(HTTP layer included — real JSON/base64 encode/decode) and reports
request rate, pixel rate, latency percentiles, and the batch-size
histogram. This measures the PRODUCTION path: micro-batching dispatcher +
render_batch + host encode, i.e. what a deployment actually serves —
complementary to bench.py's device-side numbers.

Run:     python benchmarks/serve_load.py   (JAX_PLATFORMS=cpu for the CPU)
Options via env: LOAD_SIZE=512x512 LOAD_CLIENTS=16 LOAD_REQS=8
                 LOAD_FILTER=twirl LOAD_FORMAT=raw|png LOAD_BINARY=1
                 (binary: direct image/png / octet-stream responses —
                 no base64/JSON on the response path)
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


def main():
    size = os.environ.get("LOAD_SIZE", "512x512")
    w, h = (int(v) for v in size.lower().split("x"))
    n_clients = int(os.environ.get("LOAD_CLIENTS", "16"))
    n_reqs = int(os.environ.get("LOAD_REQS", "8"))
    filt_name = os.environ.get("LOAD_FILTER", "twirl")
    fmt = os.environ.get("LOAD_FORMAT", "raw")
    binary = os.environ.get("LOAD_BINARY", "0") == "1"

    from mathmap_tpu.serve import RenderService, serve

    svc = RenderService(max_batch=32, window_ms=6.0)
    httpd, svc = serve(port=0, service=svc, block=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    from PIL import Image

    rng = np.random.RandomState(7)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    img_b64 = base64.b64encode(buf.getvalue()).decode()

    def post(path, obj, timeout=900):
        req = urllib.request.Request(
            base + path, json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    # warm: single + the power-of-2 buckets this load can actually reach
    # (a group is at most n_clients jobs here — each client blocks on its
    # own request)
    cap = min(32, n_clients)
    sizes = [1]
    b = 2
    while b < 2 * cap and b <= 32:
        sizes.append(b)
        b *= 2
    t0 = time.time()
    # the PARAM NAME SET is part of the jit signature — warm with the same
    # names the load will send or the first dispatches recompile anyway
    # each bucket is a distinct compile — don't time out under them
    post("/warmup", {"filter": filt_name, "width": w, "height": h,
                     "batch_sizes": sizes, "params": {"angle": 1.0}},
         timeout=3600)
    print(f"# warmup (buckets {sizes}): {time.time() - t0:.0f}s")

    latencies = []
    errors = []
    lock = threading.Lock()

    def client(ci):
        for k in range(n_reqs):
            t1 = time.perf_counter()
            try:
                body = {"filter": filt_name, "width": w, "height": h,
                        "t": 0.01 * (ci * n_reqs + k),
                        "params": {"angle": 1.0 + 0.1 * ci},
                        "inputs": [img_b64], "format": fmt}
                if binary:
                    body["binary"] = True
                    req = urllib.request.Request(
                        base + "/render", json.dumps(body).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=900) as r:
                        r.read()  # raw bytes — no JSON/base64 decode
                else:
                    post("/render", body)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(str(e))
                continue
            with lock:
                latencies.append((time.perf_counter() - t1) * 1e3)

    start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - start

    n_ok = len(latencies)
    lat = np.sort(np.asarray(latencies)) if latencies else np.zeros(1)
    stats = svc.snapshot()
    out = {
        "filter": filt_name, "size": f"{w}x{h}", "format": fmt,
        "binary": binary,
        "clients": n_clients, "requests_ok": n_ok, "errors": len(errors),
        "wall_s": round(wall, 2),
        "req_per_s": round(n_ok / wall, 1),
        "mpix_per_s": round(n_ok * w * h / wall / 1e6, 1),
        "latency_ms_p50": round(float(lat[len(lat) // 2]), 1),
        "latency_ms_p95": round(float(lat[int(len(lat) * 0.95)]), 1),
        "batch_hist": stats["batch_hist"],
        "dispatches": stats["dispatches"],
    }
    print(json.dumps(out))
    if errors:
        print("# first error:", errors[0][:200])
    httpd.shutdown()
    svc.shutdown()


if __name__ == "__main__":
    main()
