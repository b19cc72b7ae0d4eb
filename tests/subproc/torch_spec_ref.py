"""Run the reference's training launcher (``repro.launch.train.main``) with
``--zero1 spec`` on 8 fake CPU devices, for the runs, the resume and the
refusals of ``torch_spec_cases``.

    python tests/subproc/torch_spec_ref.py --out DIR [--runs NAME,...] [--resume] [--refusals]

Forces 8 fake CPU devices before jax is imported.  First writes
``init_ARCH.npz`` for every arch the chosen runs train: the
reduced f32 weights the launcher's ``init_params(jax.random.key(0), cfg)``
gives ("/"-joined keys, layers stacked), each written whole and renamed
into place, so the port's world can start from them at once.  Then runs
``main()`` on each run of ``--runs`` (default: every run of ``RUNS``), in
turn, with ``--ckpt-interval 1`` and three of
the launcher's module names replaced, so that what it computes can be read
back without changing how it computes it:

* ``init_params`` calls the real one and checks it gave the weights
  written above;
* ``Checkpointer`` keeps each save's parameters and first moments in
  memory: the save after the last step holds the final ones;
* ``float``, which the launcher calls on each step's loss to log it, also
  keeps the value.

Writes ``NAME.json`` (the losses and the standard output),
``NAME_final.npz`` (the final parameters) and, for the runs of
``SHARDED``, ``NAME_shards.npz``: every device's shard of every final
parameter and first moment, placed by the launcher's own specs
(``placed_shards``), keyed ``params/KEY@I`` and ``m/KEY@I`` with ``I`` the
device's index in the mesh (row-major).

With ``--resume``, the resume (``resume.json``, ``resume_final.npz``) trains ``RESUME`` for
``RESUME_STEPS[0]`` steps with the real ``Checkpointer`` (wrapped to keep
its saves), then runs ``--resume`` to ``RESUME_STEPS[1]`` steps with the
launcher's pipeline starting at the batch of the step it resumes at (see
``torch_spec_cases.RESUME``).  With ``--refusals``, every refusal of
``REFUSALS`` goes to ``refusals.json``: the ``SystemExit`` message or
``ValueError`` each gave.  Most of the time is spent compiling, so the
test splits the runs between two of these processes.
"""
from __future__ import annotations

import argparse
import builtins
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
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

import torch_spec_cases as C  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.launch import train as T  # noqa: E402


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def placed_shards(cfg, params, m):
    """``{params/KEY@I, m/KEY@I: shard}``: every device I's shard of the
    parameters and first moments placed as the launcher places its state,
    by ``sanitize_tree(param_specs)`` and ZeRO-1 ``opt_state_specs`` (the
    jitted step leaves the shardings of its outputs to the partitioner, so
    they are placed again here)."""
    from repro.models import sharding as shd
    from repro.optim import opt_state_specs

    mesh = jax.tree.leaves(params)[0].sharding.mesh
    devices = list(mesh.devices.flat)
    pspecs = shd.sanitize_tree(shd.param_specs(cfg, params), params, mesh)
    mspecs = shd.sanitize_tree(opt_state_specs(pspecs, params, mesh)["m"], m, mesh)
    out = {}
    for prefix, tree, specs in (("params", params, pspecs), ("m", m, mspecs)):
        placed = jax.device_put(tree, shd.named(mesh, specs))
        for path, a in jax.tree_util.tree_flatten_with_path(placed)[0]:
            key = "/".join(str(k.key) for k in path)
            for s in a.addressable_shards:
                out[f"{prefix}/{key}@{devices.index(s.device)}"] = np.asarray(s.data)
    return out


def _write(path: Path, arrays) -> None:
    part = path.with_name(path.name + ".part")
    with open(part, "wb") as f:
        np.savez(f, **arrays)
    os.replace(part, path)


def dump_inits(out: Path, archs) -> dict:
    """The initial weights of each of ``archs``, made in threads (most of
    the time is compiling each initializer, which runs outside the
    interpreter)."""

    def one(arch):
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        params = flat(T.init_params(jax.random.key(0), cfg))
        _write(out / f"init_{arch}.npz", params)
        return arch, params

    with ThreadPoolExecutor(len(archs)) as pool:
        return dict(pool.map(one, archs))


class _Recording:
    """Each launcher run's losses and saves."""

    def __init__(self, inits):
        self.inits, self.losses, self.saves = inits, [], []
        self.real_init, self.real_ckpt = T.init_params, T.Checkpointer

    def __enter__(self):
        rec = self

        def recording_float(x=0.0):
            v = builtins.float(x)
            if isinstance(x, jax.Array):
                rec.losses.append(v)
            return v

        def checked_init(key, cfg):
            params = rec.real_init(key, cfg)
            want = rec.inits[cfg.name]
            got = flat(params)
            assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in got)
            return params

        T.float, T.init_params = recording_float, checked_init
        return self

    def __exit__(self, *exc):
        del T.float
        T.init_params, T.Checkpointer = self.real_init, self.real_ckpt

    def keep(self, step, state):
        self.saves.append((step, state["params"], state["opt"]["m"]))


def _main(argv, stdout):
    sys.argv = ["repro.launch.train"] + argv
    with contextlib.redirect_stdout(stdout):
        T.main()


def run(name: str, inits, out: Path) -> None:
    argv = C.RUNS[name]
    steps = int(C.flag(argv, "--steps"))
    stdout = io.StringIO()
    with _Recording(inits) as rec, tempfile.TemporaryDirectory() as tmp:
        class Recorder:
            def __init__(self, directory):
                pass

            def save(self, step, state, blocking=True):
                rec.keep(step, state)

            def wait(self):
                pass

            def latest_step(self):
                return None

        T.Checkpointer = Recorder
        _main(argv + ["--ckpt-interval", "1", "--ckpt-dir", tmp], stdout)
    assert len(rec.losses) == steps + 1, rec.losses  # each step's log, then the final line
    step, params, m = rec.saves[-1]
    assert step == steps - 1, [s for s, *_ in rec.saves]
    np.savez(out / f"{name}_final.npz", **flat(params))
    if name in C.SHARDED:
        cfg = dataclasses.replace(reduced(get_config(C.arch(argv))), dtype="float32")
        np.savez(out / f"{name}_shards.npz", **placed_shards(cfg, params, m))
    (out / f"{name}.json").write_text(json.dumps(
        {"losses": rec.losses[:steps], "stdout": stdout.getvalue()}))


def resume(inits, out: Path) -> None:
    from repro.data import SyntheticLMPipeline

    first, total = C.RESUME_STEPS
    losses, stdout = [], io.StringIO()
    with _Recording(inits) as rec, tempfile.TemporaryDirectory() as tmp:
        real = rec.real_ckpt

        class Keeping(real):
            def save(self, step, state, blocking=True):
                rec.keep(step, state)
                return super().save(step, state, blocking=blocking)

        class FromResumedBatch(SyntheticLMPipeline):
            def __init__(self, cfg):
                super().__init__(cfg)
                self._step = first

        T.Checkpointer = Keeping
        _main(C.RESUME + ["--steps", str(first), "--ckpt-interval", "1", "--ckpt-dir", tmp],
              stdout)
        losses += rec.losses[:first]
        rec.losses.clear()
        real_pipe, T.SyntheticLMPipeline = T.SyntheticLMPipeline, FromResumedBatch
        try:
            _main(C.RESUME + ["--steps", str(total), "--ckpt-interval", "1", "--ckpt-dir", tmp,
                              "--resume"], stdout)
        finally:
            T.SyntheticLMPipeline = real_pipe
        losses += rec.losses[:total - first]
    step, params, _ = rec.saves[-1]
    assert step == total - 1, [s for s, *_ in rec.saves]
    np.savez(out / "resume_final.npz", **flat(params))
    (out / "resume.json").write_text(json.dumps({"losses": losses, "stdout": stdout.getvalue()}))


def refusals(out: Path) -> None:
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in C.REFUSALS.items():
            try:
                _main(argv + ["--ckpt-dir", tmp], io.StringIO())
            except SystemExit as e:
                got[name] = str(e.code)
            except ValueError as e:
                got[name] = f"ValueError: {e}"
            else:
                got[name] = None
    (out / "refusals.json").write_text(json.dumps(got))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--runs", default=",".join(C.RUNS), help="names of RUNS, comma-separated")
    ap.add_argument("--resume", action="store_true", help="also run the resume")
    ap.add_argument("--refusals", action="store_true", help="also run the refusals")
    args = ap.parse_args()
    assert len(jax.devices()) == 8, jax.devices()
    names = [n for n in args.runs.split(",") if n]
    archs = {C.arch(C.RUNS[n]) for n in names} | ({C.arch(C.RESUME)} if args.resume else set())
    inits = dump_inits(args.out, sorted(archs))
    if args.refusals:
        refusals(args.out)
    for name in names:
        run(name, inits, args.out)
    if args.resume:
        resume(inits, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
