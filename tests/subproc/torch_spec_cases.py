"""The spec-path training runs (``--zero1 spec``) that the port's world
(``torch_spec_world.py``) and the reference's launcher on 8 fake devices
(``torch_spec_ref.py``) both make, as launcher arguments, and the refusals
both must print.

Standard library only: the two scripts and ``tests/test_torch_spec_train.py``
import it.  Each script adds its own ``--ckpt-dir``, ``--ckpt-interval``
and, for the port, ``--device cpu``.
"""
from __future__ import annotations

from typing import Dict, List

_COMMON = ["--reduced", "--seq", "16", "--batch", "8", "--zero1", "spec", "--log-every", "1"]

#: the runs held to the reference: reduced granite on data 2 x model 4 and
#: on pod 2 x data 2 x model 2 (with --verify-collectives, which the spec
#: path ignores in both packages), and one run of each other family that
#: trains through the launcher
RUNS: Dict[str, List[str]] = {
    "granite": ["--arch", "granite-3-2b", "--mesh", "2,4", "--steps", "3"] + _COMMON,
    "granite-pod": ["--arch", "granite-3-2b", "--mesh", "2,2,2", "--steps", "3",
                    "--verify-collectives"] + _COMMON,
    "llama4": ["--arch", "llama4-scout-17b-a16e", "--mesh", "2,4", "--steps", "2"] + _COMMON,
    "rwkv6": ["--arch", "rwkv6-7b", "--mesh", "2,4", "--steps", "2"] + _COMMON,
    "zamba2": ["--arch", "zamba2-2.7b", "--mesh", "2,4", "--steps", "2"] + _COMMON,
}

#: the runs whose every rank's shards are held to the reference's device
#: shards (the meshes the reference lays out as 2 x 4)
SHARDED = ("granite", "llama4", "rwkv6", "zamba2")

#: the resume: granite on 2,4 trained 2 steps with a checkpoint after each,
#: then resumed from the last one up to step 3.  The reference's launcher
#: restarts its data pipeline at batch 0 on resume, the port's moves it to
#: the batch of the step it resumes at; the reference's script starts its
#: pipeline there, so both resumed steps train on the same batch
RESUME_STEPS = (2, 3)
RESUME: List[str] = ["--arch", "granite-3-2b", "--mesh", "2,4"] + _COMMON

#: argument lists both launchers refuse with the same message
REFUSALS: Dict[str, List[str]] = {
    "spec-ep": ["--arch", "llama4-scout-17b-a16e", "--reduced", "--mesh", "2,4",
                "--zero1", "spec", "--expert-parallel"],
    "spec-fault": ["--arch", "granite-3-2b", "--reduced", "--mesh", "2,4",
                   "--zero1", "spec", "--fault-step", "1"],
}

#: the reduced configs whose initial weights the runs start from
ARCHS = ("granite-3-2b", "llama4-scout-17b-a16e", "rwkv6-7b", "zamba2-2.7b")


def flag(argv: List[str], name: str) -> str:
    return argv[argv.index(name) + 1]


def arch(argv: List[str]) -> str:
    return flag(argv, "--arch")
