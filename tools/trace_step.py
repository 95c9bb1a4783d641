"""Device time of each stage of the batched serving step, from a trace.

    python tools/trace_step.py [--streams 64] [--blocks 64] [--taps 131072]
                               [--steps 5] [--out build/trace_step]

Traces ``--steps`` steady-state calls of ``jit(shared_filter_chunk_step)``
with ``jax.profiler`` and attributes every device operation of that
module to the engine stage it belongs to: the named scopes ``fwd_dft``,
``fdl_mac`` and ``inv_dft_ola`` of ``chunk_step``, read from the compiled
HLO's ``op_name`` metadata.  Prints, per step, each stage's device time
beside the bytes it must move and the floating-point operations it must
do, both computed from the shapes, and the wall time of the step with
the profiler off.  Runs on whatever device JAX picks; a time is a device
number only where that device is a GPU.

XLA's GPU command buffers (CUDA graphs) are switched off here, so that
every kernel's trace event names the HLO instruction it runs; the wall
time printed is therefore that of the step without them.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys
import time

import numpy as np

STAGES = ("fwd_dft", "fdl_mac", "inv_dft_ola")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%([\w.\-]+)")


def stage_of(op_name: str) -> str:
    # A scope shows as ".../fwd_dft/..." or, under vmap, ".../vmap(fwd_dft)/...".
    for st in STAGES:
        if re.search(rf"[/(]{st}[/)]", op_name):
            return st
    return "other"


def op_stages(hlo_text: str) -> dict:
    """HLO instruction name -> engine stage.  An instruction without
    metadata of its own (a fusion) takes its called computation's root's."""
    roots, own, calls, comp = {}, {}, {}, None
    for line in hlo_text.splitlines():
        if line and not line.startswith(" ") and "{" in line:
            comp = line.split()[0].lstrip("%") if not line.startswith("ENTRY") else "ENTRY"
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OP_NAME.search(line)
        if op:
            own[name] = op.group(1)
            if line.lstrip().startswith("ROOT"):
                roots[comp] = op.group(1)
        c = _CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    out = {}
    for name in set(own) | set(calls):
        op = own.get(name) or roots.get(calls.get(name), "")
        out[name] = stage_of(op)
    return out


def device_ns_by_stage(xplane: str, module: str, stages: dict) -> dict:
    """Sum the durations of the trace's device events of ``module`` by
    stage; also 'busy' (their union) in ns."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane)
    totals = dict.fromkeys(STAGES + ("other",), 0.0)
    spans = []
    planes = list(data.planes)
    # On a GPU the kernels are on the device planes; the host planes
    # carry launch events of the same ops, which must not count twice.
    gpu = [p for p in planes if p.name.startswith("/device:GPU:")]
    for plane in gpu or planes:
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if not str(st.get("hlo_module", "")).startswith(module):
                    continue
                op = str(st.get("hlo_op", ""))
                totals[stages.get(op, stages.get(ev.name, "other"))] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    totals["busy"] = busy
    return totals


def stage_cost(s: int, t: int, p: int, cin: int, cout: int, fragm: int, k: int) -> dict:
    """(bytes, flops) each stage must move and do, float32, from shapes."""
    from folve_tpu.engine.rfft import get_plan

    plan = get_plan(2 * fragm)
    m1, m2 = plan.m1, plan.m2
    cols = k // m1
    rows = min(m1, -(-fragm // m2))
    f, spec = 4, 2 * 4  # bytes of a real sample, of a complex bin
    fwd_blocks, inv_blocks = s * t * cin, s * t * cout
    return {
        "fwd_dft": (
            fwd_blocks * (fragm * f + k * spec),
            fwd_blocks * (2 * 2 * m1 * rows * m2 + 6 * m1 * m2 + 4 * 2 * m1 * m2 * cols),
        ),
        "fdl_mac": (
            s * ((t + p - 1) * cin + (p - 1) * cin + t * cout) * k * spec
            + p * cin * cout * k * spec,
            8 * s * t * k * p * cin * cout,
        ),
        "inv_dft_ola": (
            inv_blocks * (k * spec + fragm * f) + 2 * s * cout * fragm * f,
            inv_blocks * (4 * 2 * m1 * cols * m2 + 6 * m1 * m2 + 2 * 2 * m1 * m1 * m2),
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--taps", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("build", "trace_step"))
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_enable_command_buffer" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_gpu_enable_command_buffer=".strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax
    import jax.numpy as jnp

    from folve_tpu.engine import compile_filter_bank, init_state, shared_filter_chunk_step
    from folve_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    rng = np.random.default_rng(0)
    ir = (rng.standard_normal((2, 2, args.taps)) / np.sqrt(args.taps)).astype(np.float32)
    bank = compile_filter_bank(ir)
    s, t, b = args.streams, args.blocks, bank.fragm
    p, cin, cout, _, k = bank.h_spec.shape
    x = jax.device_put(rng.uniform(-0.25, 0.25, (s, t, cin, b)).astype(np.float32))
    nv = jnp.full((s,), t * b, jnp.int32)
    states = jax.vmap(lambda _: init_state(bank))(jnp.arange(s))
    compiled = jax.jit(shared_filter_chunk_step).lower(bank, states, x, nv).compile()
    stages = op_stages(compiled.as_text())
    for _ in range(3):  # warm up
        states, y = compiled(bank, states, x, nv)
    y.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        states, y = compiled(bank, states, x, nv)
    y.block_until_ready()
    wall_ms = 1000 * (time.perf_counter() - t0) / args.steps

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            states, y = compiled(bank, states, x, nv)
        y.block_until_ready()
    xplane = max(
        glob.glob(os.path.join(args.out, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    ns = device_ns_by_stage(xplane, "jit_chunk_step", stages)
    cost = stage_cost(s, t, p, cin, cout, b, k)
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind}; S={s} T={t} taps={args.taps} "
          f"(fragm {b}, P {p}, K {k}); {args.steps} traced steps")
    print(f"wall step (profiler off): {wall_ms:.3f} ms")
    rows = {}
    for st in STAGES + ("other", "busy"):
        ms = ns[st] / 1e6 / args.steps
        by, fl = cost.get(st, (0, 0))
        rows[st] = {"device_ms": ms, "bytes": by, "flops": fl}
        rate = (f"; {by / 1e9:.3f} GB -> {by / ms / 1e6:.0f} GB/s, "
                f"{fl / 1e9:.1f} GFLOP -> {fl / ms / 1e9:.1f} TFLOP/s") if by and ms else ""
        print(f"  {st:12s} {ms:9.3f} ms/step{rate}")
    with open(os.path.join(args.out, "stages.json"), "w") as f:
        json.dump({"device": [d.platform, d.device_kind], "wall_ms": wall_ms,
                   "shape": [s, t, args.taps], "stages": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
