"""Run the reference's (JAX) ``launch/perf.py`` sections that need a mesh,
for ``tests/test_torch_perf.py``.

    python tests/subproc/torch_perf_ref.py --out OUT.json

Forces 8 fake CPU devices before jax is imported and starts the backend
before ``repro.launch.perf`` is imported (as ``tests/conftest.py`` does),
then calls ``repro.launch.perf.faults_bench("2,4", "64,1024",
optical_w=8)``, ``moe_block_bench("2,4", reps=1)`` (both MoE archs) and
``calibrate_links("2,4", "1,64")`` under each fixed timer of
``torch_perf_world.FIXED_TIMINGS`` (the port's world runs its own under the
same timers), and writes their rows and documents as one JSON object,
``{"faults": [...], "moe": [...], "calibrate_fixed": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from torch_perf_world import CALIBRATE_SIZES_KB, FACTORS, FIXED_TIMINGS, fixed_time_us

# 8 fake devices; XLA's CPU backend compiles without its LLVM optimisation
# passes (7 of 19 s): the rows compared are plans and modeled prices, and
# the reference's own allclose check runs under the same flags
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           + " --xla_backend_optimization_level=0"
                           + " --xla_llvm_disable_expensive_passes=true")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402

# the backend starts with 8 devices before repro.launch.dryrun (imported by
# repro.launch.perf) overwrites XLA_FLAGS with its own count
jax.devices()

from repro.launch import perf  # noqa: E402

#: the sections' inputs, shared with the port's side of the test
FAULTS = dict(factors="2,4", sizes_kb="64,1024", optical_w=8)
MOE = dict(factors="2,4", reps=1)


def fixed_calibrations() -> dict:
    """The reference's ``calibrate_links`` under each fixed timer, its
    document read back from the ``--links`` file it writes."""
    real = perf._timed
    docs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for timing in FIXED_TIMINGS:
                # the timer's argument is the global array: the gathered payload
                perf._timed = (lambda fn, x, reps=10, timing=timing:
                               fixed_time_us(timing, x.nbytes))
                path = Path(tmp) / f"{timing}.json"
                perf.calibrate_links(",".join(map(str, FACTORS)),
                                     ",".join(map(str, CALIBRATE_SIZES_KB)), reps=1,
                                     links_path=str(path))
                docs[timing] = json.loads(path.read_text())
    finally:
        perf._timed = real
    return docs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if jax.device_count() != 8:
        raise SystemExit(f"wanted 8 fake devices, have {jax.device_count()}")
    t0 = time.perf_counter()
    doc = {"faults": perf.faults_bench(FAULTS["factors"], FAULTS["sizes_kb"],
                                       optical_w=FAULTS["optical_w"]),
           "moe": perf.moe_block_bench(MOE["factors"], reps=MOE["reps"]),
           "calibrate_fixed": fixed_calibrations()}
    Path(args.out).write_text(json.dumps(doc))
    print(f"[torch_perf_ref] faults, moe and calibrate on {jax.device_count()} devices in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
