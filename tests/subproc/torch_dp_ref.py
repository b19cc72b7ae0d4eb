"""Run the reference's training launcher (``repro.launch.train.main``) on 8
fake CPU devices, for the runs and refusals of ``torch_dp_cases``.

    python tests/subproc/torch_dp_ref.py --run dense --init INIT.npz --out DIR [--refusals]

Forces 8 fake CPU devices before jax is imported.  ``--run NAME`` runs
``main()`` on ``torch_dp_cases.RUNS[NAME]`` with ``--ckpt-interval 1``
and three of the launcher's module names replaced, so that what it computes
can be read back without changing how it computes it:

* ``init_params`` calls the real one and writes what it gave to
  ``--init`` (written whole, then renamed into place): the weights the
  port's world starts from;
* ``Checkpointer`` keeps each save's parameters in memory: the save after
  the last step holds the final parameters;
* ``float``, which the launcher calls on each step's loss to log it, also
  keeps the value (the log prints 4 decimals).

Writes ``NAME_final.npz`` (the final parameters, "/"-joined keys, layers
stacked) and ``NAME.json`` (the losses and the launcher's standard
output).  ``--refusals`` then runs every refusal of
``torch_dp_cases.REFUSALS`` and writes ``refusals.json``: the
``SystemExit`` message or the ``ValueError`` each one raised.
"""
from __future__ import annotations

import argparse
import builtins
import contextlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_dp_cases as C  # noqa: E402
from repro.launch import train as T  # noqa: E402


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _main(argv, stdout):
    sys.argv = ["repro.launch.train"] + argv
    with contextlib.redirect_stdout(stdout):
        T.main()


def run(name: str, init_path: Path, out: Path) -> None:
    argv = C.RUNS[name]
    steps = int(C.flag(argv, "--steps"))
    losses, saves = [], []
    real_init = T.init_params

    def recording_float(x=0.0):
        v = builtins.float(x)
        if isinstance(x, jax.Array):
            losses.append(v)
        return v

    class Recorder:
        def __init__(self, directory):
            pass

        def save(self, step, state, blocking=True):
            saves.append((step, flat(state["params"])))

        def wait(self):
            pass

        def latest_step(self):
            return None

    def dumping_init(key, cfg):
        params = real_init(key, cfg)
        part = init_path.with_name(init_path.name + ".part")
        with open(part, "wb") as f:
            np.savez(f, **flat(params))
        os.replace(part, init_path)
        return params

    real = T.Checkpointer
    T.float, T.Checkpointer, T.init_params = recording_float, Recorder, dumping_init
    stdout = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _main(argv + ["--ckpt-interval", "1", "--ckpt-dir", tmp], stdout)
    finally:
        del T.float
        T.Checkpointer, T.init_params = real, real_init
    assert len(losses) == steps + 1, losses  # each step's log, then the final line
    assert saves and saves[-1][0] == steps - 1, [s for s, _ in saves]
    np.savez(out / f"{name}_final.npz", **saves[-1][1])
    (out / f"{name}.json").write_text(json.dumps(
        {"losses": losses[:steps], "stdout": stdout.getvalue()}))


def refusals(out: Path) -> None:
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in C.REFUSALS.items():
            try:
                _main(argv + C.REF_MESH.get(name, []) + ["--ckpt-dir", tmp], io.StringIO())
            except SystemExit as e:
                got[name] = str(e.code)
            except ValueError as e:
                got[name] = f"ValueError: {e}"
            else:
                got[name] = None
    (out / "refusals.json").write_text(json.dumps(got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=sorted(C.RUNS), required=True)
    ap.add_argument("--init", type=Path, required=True,
                    help="where to write the initial weights (.npz)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--refusals", action="store_true", help="then run the refusals")
    args = ap.parse_args()
    assert len(jax.devices()) == 8, jax.devices()
    run(args.run, args.init, args.out)
    if args.refusals:
        refusals(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
