"""Code generators: export a filter as standalone artifacts.

Reference: `generators/` (export a filter as a plugin for another host,
e.g. Blender — SURVEY.md §2.1 code-generators row, marked LOW confidence
[unverified — mount empty, SURVEY.md §0]). The rebuild exports:

  - `export_python(filter, path)`: a self-contained Python script embedding
    the .mm source and a minimal CLI (requires mathmap_tpu at run time).
  - `export_stablehlo(filter, ...)`: the filter's lowered StableHLO text —
    the portable compiled artifact of this framework (the analog of the
    reference exporting generated C).
"""

from __future__ import annotations

import json

_TEMPLATE = '''#!/usr/bin/env python
"""Standalone MathMap filter: {name} (generated by mathmap_tpu)."""

import argparse

import mathmap_tpu as mm

SOURCE = {source!r}
DEFAULT_PARAMS = {params}


def main():
    ap = argparse.ArgumentParser(description="render the {name!r} filter")
    ap.add_argument("images", nargs="*", help="input image(s)..., output image")
    ap.add_argument("--size", default=None)
    ap.add_argument("--t", type=float, default=0.0)
    ap.add_argument("--param", action="append", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    *inputs, out_path = args.images
    params = dict(DEFAULT_PARAMS)
    for item in args.param:
        k, v = item.split("=", 1)
        params[k] = float(v)
    width = height = None
    if args.size:
        width, height = (int(v) for v in args.size.lower().split("x"))
    filt = mm.compile(SOURCE, main={name!r})
    out = filt.render(*[mm.read_image(p) for p in inputs],
                      width=width, height=height, t=args.t, params=params)
    mm.write_image(out_path, out)


if __name__ == "__main__":
    main()
'''


def export_python(filt, path: str, params: dict | None = None) -> None:
    """Write a runnable Python script embedding the filter."""
    defaults = {}
    for p in filt.params:
        if p.kind in ("int", "float", "bool") and p.default is not None:
            defaults[p.name] = p.default
    defaults.update(params or {})
    script = _TEMPLATE.format(
        name=filt.name, source=filt.source, params=json.dumps(defaults)
    )
    with open(path, "w") as f:
        f.write(script)


def export_stablehlo(filt, width: int, height: int, options=None) -> str:
    """Lower the filter's render step to StableHLO text (portable artifact)."""
    import jax
    import numpy as np

    from ..runtime.options import RenderOptions

    options = options or RenderOptions()
    renderer = filt._renderer(width, height, options, 1)
    n_imgs = len(filt.image_params)
    ins = [np.zeros((height, width, 4), np.float32) for _ in range(n_imgs)]
    import jax.numpy as jnp

    lowered = jax.jit(
        lambda inputs, t: renderer._jitted(inputs, {}, (), t, jnp.float32(0.0))
    ).lower([jnp.asarray(a) for a in ins], jnp.float32(0.0))
    return lowered.as_text()
