"""Where torch.profiler loses kernel records on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_profiler_window
[--seconds S] [--pad_ms P]``.

``chip_smoke.py`` counts the decode kernel's launches from a profile, and a
session late in a process sometimes counted a few fewer than the program
launched (ROADMAP C.10).  Kineto keeps a device record only when the
kernel lies inside the session's window on the host's clock
(``GenericActivityProfiler::outOfRange``), so a kernel at either end of a
session is lost when the device's timestamps, mapped onto the host's
clock, run ahead of it or behind it.

For ``--seconds`` this script opens one CUDA-only profiler session after
another, in turns without a pad and with ``--pad_ms`` (by default
``utils/benchlib.PROFILE_PAD_S``, ``device_profile``'s pad) of host sleep
after the session starts and before it stops.  Each session launches a
marker kernel (``fill_``), then 8 steps of 154 small ``add_`` kernels (a
decode profile's launches), then a second marker (``neg_``), and
synchronises.  For each variant it prints
the sessions, those that lost a record, the records lost at the first
marker, the body and the last marker, and the margins on the host's clock
(ns since the epoch, ``time.time_ns`` against the records' ``start_ns`` and
``end_ns``): the first kernel's start less the host time read after the
session started, and the host time read after the final synchronise less
the last kernel's end.  A negative margin is a device record that the
host's clock puts outside the window.  It needs a CUDA card and fails
without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from sparse_matrix_fine_tuning_torch.utils import benchlib

STEPS, PER_STEP = 8, 154  # chip_smoke.py's DECODE_PROFILE_STEPS, its adapted linears


def session(pad_s: float, tensors) -> dict:
    """One profiler session of the marker, body and marker kernels; the
    records it kept of each, and the margins (ns) at its two ends."""
    from torch.profiler import ProfilerActivity, profile

    first, body, last = tensors
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        host_start = time.time_ns()
        first.fill_(0)
        for _ in range(STEPS):
            for _ in range(PER_STEP):
                body.add_(1)
        last.neg_()
        torch.cuda.synchronize()
        host_end = time.time_ns()
        time.sleep(pad_s)
    kept = {"first": 0, "body": 0, "last": 0}
    starts, ends = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        role = ("first" if "Fill" in name else "last" if "neg" in name
                else "body" if "add" in name else None)
        if role is None:
            continue
        kept[role] += 1
        starts.append(ev.start_ns())
        ends.append(ev.end_ns())
    return {"pad_ms": pad_s * 1e3, **kept,
            "lost": 2 + STEPS * PER_STEP - sum(kept.values()),
            "start_margin_ns": min(starts) - host_start if starts else None,
            "end_margin_ns": host_end - max(ends) if ends else None}


def summary(rows: list) -> dict:
    """The variant's sessions, losses and margins."""
    def spread(key):
        vals = [r[key] for r in rows if r[key] is not None]
        return {"min": min(vals), "median": statistics.median(vals), "max": max(vals)}

    return {"sessions": len(rows), "sessions_with_a_loss": sum(r["lost"] > 0 for r in rows),
            "lost": sum(r["lost"] for r in rows),
            "lost_first": sum(1 - r["first"] for r in rows),
            "lost_body": sum(STEPS * PER_STEP - r["body"] for r in rows),
            "lost_last": sum(1 - r["last"] for r in rows),
            "start_margin_ns": spread("start_margin_ns"), "end_margin_ns": spread("end_margin_ns")}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=120.0)
    p.add_argument("--pad_ms", type=float, default=benchlib.PROFILE_PAD_S * 1e3)
    args = p.parse_args(argv)
    benchlib.require_card("probe_profiler_window")
    print(benchlib.card_line(), flush=True)
    tensors = [torch.zeros(4, 2048, dtype=torch.bfloat16, device="cuda") for _ in range(3)]
    rows = {0.0: [], args.pad_ms: []}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for pad in rows:
            rows[pad].append(session(pad / 1e3, tensors))
    result = {f"pad {pad} ms": summary(r) for pad, r in rows.items()}
    for label, s in result.items():
        print(f"{label}: {json.dumps(s)}", flush=True)
    losses = [(i, r) for pad in rows for i, r in enumerate(rows[pad]) if r["lost"]]
    for i, r in losses[:40]:
        print(f"session {i}: {r}", flush=True)


if __name__ == "__main__":
    main()
