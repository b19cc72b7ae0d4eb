"""Run the port's ``launch/perf.py`` world sections in one world of 8 gloo
processes, for ``tests/test_torch_perf.py``.

    python tests/subproc/torch_perf_world.py --out OUT.json --links LINKS.json

Torch only (no jax).  One world (``repro_torch.launch.world.run_world``,
8 ranks, one CPU thread each, a ``FileStore`` in a fresh temporary
directory) runs, in turn: ``moe_block_bench`` on the mesh [2, 4] (both MoE
archs, ``reps=1``); ``calibrate_links`` on [2, 4] at 1 and 64 KiB, which
writes ``--links``; ``collectives_bench`` on [2, 4] at 1 KiB with
``links_path=--links``, which re-plans with the fitted specs; and
``calibrate_links`` again under each of :data:`FIXED_TIMINGS`, its timer
replaced by a fixed function of the gathered payload.  Rank 0 prints the
sections' lines and writes the MoE rows and the calibration documents to
``--out`` as JSON.

``tests/subproc/torch_perf_ref.py`` imports :data:`FIXED_TIMINGS` and
:func:`fixed_time_us` to run the reference's ``calibrate_links`` under the
same timer.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: a hung world fails in minutes, not at a test suite's limit
WORLD_TIMEOUT_S = 150
FACTORS = [2, 4]
CALIBRATE_SIZES_KB = [1, 64]
#: timers for the calibration fit, (µs, µs a byte of the gathered payload):
#: a size dependence that identifies a bandwidth, and none or a falling one
#: that does not
FIXED_TIMINGS = {"sloped": (8.0, 2.5e-3), "steep": (100.0, 0.5),
                 "flat": (40.0, 0.0), "falling": (500.0, -1e-3)}


def fixed_time_us(timing, payload_bytes):
    """The µs ``timing`` gives an all-gather of ``payload_bytes`` in all."""
    base, per_byte = FIXED_TIMINGS[timing]
    return base + per_byte * payload_bytes


def _fixed_calibrations(dev, perf):
    """``calibrate_links`` under each fixed timer; the all-gather still runs
    once a point, and its output's size is the payload."""
    real = perf._timed
    docs = {}
    try:
        for timing in FIXED_TIMINGS:
            def timed(fn, reps, dev, timing=timing):
                out = fn()
                return fixed_time_us(timing, out.numel() * out.element_size())

            perf._timed = timed
            docs[timing] = perf.calibrate_links(dev, FACTORS, CALIBRATE_SIZES_KB, reps=1)
    finally:
        perf._timed = real
    return docs


def _sections(dev, links_path):
    from repro_torch.launch import perf

    moe = perf.moe_block_bench(dev, FACTORS, reps=1)
    fitted = perf.calibrate_links(dev, FACTORS, CALIBRATE_SIZES_KB, reps=1,
                                  links_path=links_path)
    perf.collectives_bench(dev, FACTORS, [1], reps=1, links_path=links_path)
    return {"moe": moe, "calibrate": fitted, "calibrate_fixed": _fixed_calibrations(dev, perf)}


def main(argv=None) -> int:
    from repro_torch.launch.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--links", required=True)
    args = ap.parse_args(argv)
    doc = run_world(8, "cpu", _sections, {"links_path": args.links}, WORLD_TIMEOUT_S,
                    "torch_perf_world")
    Path(args.out).write_text(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
