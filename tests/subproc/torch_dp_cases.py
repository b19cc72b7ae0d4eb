"""The data-parallel training runs that the port's world
(``torch_dp_world.py``) and the reference's launcher on 8 fake devices
(``torch_dp_ref.py``) both make, as launcher arguments, and the refusals
both must print.

Standard library only: the two drivers and ``tests/test_torch_dp_train.py``
import it.  Each driver adds its own ``--ckpt-dir``, ``--ckpt-interval``
and, for the port, ``--device cpu``.
"""
from __future__ import annotations

import math
from typing import Dict, List

#: the runs held to the reference: dense reduced granite over pod 2 x data
#: 4, with verified collectives and a fault reported before step 1; the
#: reduced llama4 (4 experts) with its experts over data 4
RUNS: Dict[str, List[str]] = {
    "dense": ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,4,1", "--seq", "32",
              "--batch", "8", "--steps", "3", "--zero1", "explicit",
              "--verify-collectives", "--fault-step", "1", "--log-every", "1"],
    "ep": ["--arch", "llama4-scout-17b-a16e", "--reduced", "--mesh", "4,1", "--seq", "32",
           "--batch", "8", "--steps", "3", "--zero1", "explicit", "--expert-parallel",
           "--log-every", "1"],
}

#: the port's resume check: 2 ranks, 4 steps with a save every 2; run
#: unbroken, then resumed at step 2 from a copy of its checkpoints
RESUME: List[str] = ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,1", "--zero1",
                     "explicit", "--seq", "16", "--batch", "2", "--steps", "4",
                     "--log-every", "1", "--ckpt-interval", "2"]

#: argument lists both launchers refuse with the same message
REFUSALS: Dict[str, List[str]] = {
    "ep-needs-explicit": ["--arch", "llama4-scout-17b-a16e", "--reduced",
                          "--expert-parallel"],
    "ep-needs-moe": ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,4",
                     "--zero1", "explicit", "--expert-parallel"],
    "model-axis": ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,2",
                   "--zero1", "explicit"],
    "batch": ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,4,1",
              "--zero1", "explicit", "--batch", "6"],
    "fault-needs-explicit": ["--arch", "granite-3-2b", "--reduced", "--fault-step", "1"],
}
#: the reference's --mesh defaults to 16,16 (256 devices): where a refusal
#: comes after its mesh is made, it gets one of 8 devices
REF_MESH: Dict[str, List[str]] = {"fault-needs-explicit": ["--mesh", "2,4"]}


def flag(argv: List[str], name: str) -> str:
    return argv[argv.index(name) + 1]


def world_size(argv: List[str]) -> int:
    return math.prod(int(x) for x in flag(argv, "--mesh").split(","))


def arch(argv: List[str]) -> str:
    return flag(argv, "--arch")
